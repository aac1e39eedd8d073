"""The plain reference: plain PyTorch, independent of the code under test."""
