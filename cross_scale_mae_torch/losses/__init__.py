"""Training losses: masked reconstruction and NT-Xent."""
