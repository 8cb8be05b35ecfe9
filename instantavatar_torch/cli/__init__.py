"""The port's entry points: ``python -m instantavatar_torch.cli.train``,
``.eval``, ``.fit``, ``.animate`` and ``.novel_view``, with the same
``--config-name`` and ``key=value`` surface as the repository's
``cli/*.py``, plus ``+device=cuda|cpu``."""
