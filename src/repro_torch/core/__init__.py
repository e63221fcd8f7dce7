"""Format and backend layer of the port (numpy packing, torch dispatch)."""
