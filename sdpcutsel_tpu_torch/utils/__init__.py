"""Development aids of the port (debug mode) and round checkpoints."""
