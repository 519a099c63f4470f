"""`python -m molchanica_tpu_torch` — the headless CLI (see cli.py)."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
