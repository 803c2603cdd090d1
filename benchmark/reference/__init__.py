"""The plain references, one module a kind of configuration: each computes
the answers from the configuration and the requests alone, with code of
its own. None imports the port or takes anything the port made; a
configuration names its module here (``"reference"`` in
``configs/<name>.json``)."""
