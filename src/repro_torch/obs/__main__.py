"""CLI: ``python -m repro_torch.obs trace.json`` validates a Chrome trace
file."""
import sys

from repro_torch.obs.export import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
