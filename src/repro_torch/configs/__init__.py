"""One config module per assigned architecture, copied from
``repro/configs`` (``models.registry.get_config`` resolves them here)."""
