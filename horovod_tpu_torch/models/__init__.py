"""Models of the port (slice 1: the Llama LM and its weight
converter)."""
