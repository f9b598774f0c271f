"""Scanner, duplicate grouping and the JSON report."""
