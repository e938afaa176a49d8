"""Development aids of the port (debug mode)."""
