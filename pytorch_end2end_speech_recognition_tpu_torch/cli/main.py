"""Genre-style unified entry point (the port of the JAX package's
`cli/main.py`): `main.py --config x [--test]`.

Train by default; --test decodes the config's test manifest with the
configured decode mode. All train/decode flags pass through, `--device`
included.

    python -m pytorch_end2end_speech_recognition_tpu_torch.cli.main \
        --config libri960_conformer [--test] [--set k=v ...]
"""

from __future__ import annotations

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--test" in argv:
        argv.remove("--test")
        from pytorch_end2end_speech_recognition_tpu_torch.cli import decode
        from pytorch_end2end_speech_recognition_tpu_torch.cli.train import (
            load_config,
        )

        # default the manifest to the config's test set when not given
        if "--manifest" not in argv:
            try:
                i = argv.index("--config")
                cfg = load_config(argv[i + 1])
                argv += ["--manifest", cfg.data.test_manifest]
            except (ValueError, IndexError):
                pass
        return decode.main(argv)
    from pytorch_end2end_speech_recognition_tpu_torch.cli import train

    return train.main(argv)


if __name__ == "__main__":
    main()
