"""Core runtime: errors, logging, stats."""
