"""LM substrate: parameters, norms, the Mamba-2 SSD block and the stack."""
