"""Core helpers of the port: errors, integer utilities, device resolution."""
