"""Command-line tools and synthetic inputs of the port."""
