"""The plain reference: each model family's training loss in plain
PyTorch, float32 with TF32 off, written from the published architecture
and independent of the program (it imports nothing of it, nor of JAX).
``common.py`` holds what the families share; ``train.py`` drives a few
AdamW steps and returns what the check compares."""
