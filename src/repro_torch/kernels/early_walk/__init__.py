"""The single-query early-termination walk of ``search_early``."""
