"""Engineering layers of the port (threads)."""
