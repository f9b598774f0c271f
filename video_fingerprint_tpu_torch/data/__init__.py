"""Host-side decode and preprocess."""
