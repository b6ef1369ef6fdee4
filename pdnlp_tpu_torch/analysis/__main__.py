"""``python -m pdnlp_tpu_torch.analysis`` — the torchlint CLI."""
import sys

from pdnlp_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
