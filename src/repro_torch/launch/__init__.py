"""Launchers of the port: the LM serving entry point."""
