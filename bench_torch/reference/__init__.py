"""The plain references, one file each, named by the entries that use
them: plain PyTorch in float64, with no kernel and nothing else of the
port."""
