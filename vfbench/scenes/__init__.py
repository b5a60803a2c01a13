"""Frozen scene generators, one module a scene: ``build(config, seed, **options)``."""
