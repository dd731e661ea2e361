"""The LM substrate: layers, the RWKV6 blocks and the decoder."""
