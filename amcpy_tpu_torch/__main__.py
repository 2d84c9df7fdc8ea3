"""``python -m amcpy_tpu_torch ...`` runs the command-line interface."""

import sys

from amcpy_tpu_torch.cli import main

if __name__ == "__main__":
    main(sys.argv[1:])
