"""Host-side helpers the port keeps its own copies of (config knobs,
logging)."""
