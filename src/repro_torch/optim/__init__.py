"""Optimizers and gradient compression of the port: AdamW, int8 weight
quantization, int8 gradient compression with error feedback."""
