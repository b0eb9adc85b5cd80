"""The dense model, its layers and attention, in PyTorch."""
