"""The plain reference: float32 forwards, exact search, seeded weights, controls."""
