"""The plain reference: plain PyTorch at float32, importing nothing of the
program."""
