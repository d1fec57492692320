"""Entry point mirroring the reference train/level.py."""

from pacednegatives_tpu_torch.cli.train import main

if __name__ == "__main__":
    main(preset={"curriculum": "level"})
