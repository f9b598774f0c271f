"""Weight layout conversion and test-corpus helpers."""
