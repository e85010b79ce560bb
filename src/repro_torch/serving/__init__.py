"""Master scheduler and the search service."""
