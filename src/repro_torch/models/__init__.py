"""Dense decoder-only LM of the port."""
