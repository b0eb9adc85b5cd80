"""The synthetic token stream and its loader."""
