"""Wire codec for the data model (the parts ``structs`` calls)."""
