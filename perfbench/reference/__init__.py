"""The benchmark's plain reference: SPAIR in plain PyTorch (``spair``), what
both sides are handed from the seed (``inputs``), and the reference's own
training steps (``runs``). Nothing here imports the program
under test."""
