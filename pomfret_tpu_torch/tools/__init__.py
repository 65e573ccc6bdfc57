"""Command-line tools of the port that are not subcommands of its CLI."""
