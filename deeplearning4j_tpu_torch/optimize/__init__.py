"""Training listeners of the port."""
