"""Golden traces and read-only fixture comparison for the port."""
