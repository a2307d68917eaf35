"""Launchers: the serving entry point (:mod:`.serve`)."""
