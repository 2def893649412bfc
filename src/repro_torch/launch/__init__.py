"""Launchers of the port: step builders (``steps``), the production meshes
(``mesh``), the dry run of every (arch x shape) cell (``dryrun``), and
the serving and training CLIs (``serve``, ``train``)."""
