"""Model zoo of the port (dense decoder)."""
