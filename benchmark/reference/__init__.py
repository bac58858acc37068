"""The plain reference: ProtoPFormer's forward and train step in plain
PyTorch, float32. It imports nothing of the program."""
