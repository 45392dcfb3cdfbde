"""Model and architecture configurations: copies of ``repro.configs`` with
only the imports changed, so ``list_archs()`` and every config match."""
