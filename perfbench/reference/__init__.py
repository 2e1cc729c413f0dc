"""The plain reference: Hu & Ramanan's detector (arXiv:1612.04402) and its
evaluation and training rules in plain PyTorch and NumPy, float32 with TF32
off unless a control asks otherwise. It imports nothing of the port and
takes nothing the port made: the harness hands both sides the same weights
and inputs, and the reference works out again whatever the port derives
from them."""
