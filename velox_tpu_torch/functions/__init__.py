"""Function packages (Presto-semantic scalars for now)."""
