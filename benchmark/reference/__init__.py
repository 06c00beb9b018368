"""The plain reference."""
