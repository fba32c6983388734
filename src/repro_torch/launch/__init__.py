"""Entry points of the port: `serve` (hedged LM serving)."""
