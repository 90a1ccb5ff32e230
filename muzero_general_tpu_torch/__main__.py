"""`python -m muzero_general_tpu_torch [game] ['{json overrides}']` entry point.

CLI parity with `python muzero.py [game] [config]` (reference
muzero.py:622-712); runs on the CUDA card.
"""

from muzero_general_tpu_torch.muzero import main

if __name__ == "__main__":
    main()
