"""Dataset constants the serving path needs."""
