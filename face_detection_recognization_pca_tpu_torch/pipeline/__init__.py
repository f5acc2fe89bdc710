"""End-to-end apps: the tracked video scan."""
