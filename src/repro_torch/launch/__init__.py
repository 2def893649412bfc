"""Launchers of the port: step builders (``steps``) and the serving CLI
(``serve``)."""
