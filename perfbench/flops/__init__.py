"""The yardstick's arithmetic: the chip's peaks, each family's model
FLOPs a token and its attention shapes, and the flash kernels' bound."""
