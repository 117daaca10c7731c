"""``python -m audioldm2_torch``: the port's CLI (see ``cli.py``)."""

from audioldm2_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
