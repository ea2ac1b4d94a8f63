"""Scoring: word and character error rates."""
