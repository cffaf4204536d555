"""Host-side utilities of the port: raw/BMP IO, the debug dump and its
renders (NumPy, no device code)."""
