"""Stage loaders (the CLI subcommands come with later slices)."""
