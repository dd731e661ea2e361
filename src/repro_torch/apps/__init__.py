"""Applications on the port: the end-to-end read mapper."""
