"""Plain reference implementations: they import nothing of the port."""
