"""The head's config: the base config, interpolation, resolvers and
overrides."""
