"""
iscc-search-tpu CLI.

Command surface parity with the reference CLI (cli/__init__.py:28-50):
add, get, search, serve, index {add,list,use,remove,rebuild}, hub, datasets,
version — built on click + rich (typer is unavailable in this environment).
"""

from __future__ import annotations

import click

import iscc_search_tpu
from iscc_search_tpu.cli.add import add_command
from iscc_search_tpu.cli.datasets import datasets_command
from iscc_search_tpu.cli.get import get_command
from iscc_search_tpu.cli.hub import hub_command
from iscc_search_tpu.cli.index import index_group
from iscc_search_tpu.cli.search import search_command
from iscc_search_tpu.cli.serve import serve_command


@click.group(context_settings={"help_option_names": ["-h", "--help"]})
def cli():
    """ISCC-Search — similarity search for ISCC codes on accelerators."""
    from iscc_search_tpu.utils import configure_logging

    configure_logging()  # entry point opts in; the library never does on import


@cli.command("version")
def version_command():
    """Show version information."""
    click.echo(f"iscc-search-tpu {iscc_search_tpu.__version__}")


cli.add_command(add_command)
cli.add_command(get_command)
cli.add_command(search_command)
cli.add_command(serve_command)
cli.add_command(index_group)
cli.add_command(hub_command)
cli.add_command(datasets_command)


def main():  # pragma: no cover - console entry point
    cli()
