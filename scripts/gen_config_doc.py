"""Regenerate docs/reference/configuration.md from SearchOptions (the source of truth).

Run: PYTHONPATH=. python scripts/gen_config_doc.py
"""

from pathlib import Path


def render():
    # type: () -> str
    from iscc_search_tpu.options import SearchOptions

    lines = [
        "# Configuration reference",
        "",
        "All server/runtime knobs come from `ISCC_SEARCH_*` environment variables",
        "(12-factor style; generated from `iscc_search_tpu.options.SearchOptions`,",
        "the single source of truth — regenerate with",
        "`python scripts/gen_config_doc.py` after changing options).",
        "",
        "| Variable | Default | Description |",
        "|---|---|---|",
    ]
    for name, field in SearchOptions.model_fields.items():
        desc = field.description or ""
        var, _, rest = desc.partition(" - ")
        if not var.startswith("ISCC_SEARCH_"):
            var, rest = f"ISCC_SEARCH_{name.upper()}", desc
        default = field.get_default(call_default_factory=False)
        if callable(getattr(field, "default_factory", None)) and default is None:
            # Key on the field, not on "has a factory": any future
            # factory-backed field would otherwise be documented as a
            # platform dir it has nothing to do with.
            default = "(XDG data dir)" if name == "index_uri" else "(computed)"
        lines.append(f"| `{var}` | `{default}` | {rest.replace('|', '/')} |")
    lines += [
        "",
        "Store-level knobs:",
        "",
        "| Variable | Default | Description |",
        "|---|---|---|",
        "| `TRUCTSTORE_EXT_MIN` | `64` | externalize plain store values >= this many bytes (kept on disk, pread on demand); 0 keeps everything in RAM |",
        "",
    ]
    return "\n".join(lines)


if __name__ == "__main__":
    out = Path(__file__).resolve().parent.parent / "docs" / "reference" / "configuration.md"
    out.write_text(render())
    print(f"wrote {out}")
