"""Built-in parameter data (approximate public-literature values)."""
