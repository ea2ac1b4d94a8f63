"""Beam search: the on-device joint CTC/attention decoder and its oracle."""
