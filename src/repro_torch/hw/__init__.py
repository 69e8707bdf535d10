"""Paper hardware constants and the eDRAM SPICE fit (numpy)."""
