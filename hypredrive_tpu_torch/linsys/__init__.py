"""Linear-system layer: build from config or API."""
