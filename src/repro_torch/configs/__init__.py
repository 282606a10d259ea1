"""Per-arch configs of the port; each module registers itself on import."""
