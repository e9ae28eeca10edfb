"""Model configurations, one module per architecture (the reference's
``repro/configs``).  Only ``qwen15_4b`` is ported so far; the registry of
``repro/configs/__init__.py`` comes with the outer layers."""
