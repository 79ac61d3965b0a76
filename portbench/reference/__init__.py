"""The plain reference and the yardstick's arithmetic."""
