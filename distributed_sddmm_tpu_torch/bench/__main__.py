import sys

from distributed_sddmm_tpu_torch.bench.cli import main

if __name__ == "__main__":
    sys.exit(main())
