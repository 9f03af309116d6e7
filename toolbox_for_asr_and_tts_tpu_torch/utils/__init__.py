"""Framework-free helpers copied from the reference as the port needs them."""
