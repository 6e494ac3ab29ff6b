"""Branch-coverage round 9: codec validation edges, packing single-code
helpers, topk metric validation, memory-backend delete-during-query race."""

import base64

import pytest

from iscc_search_tpu import codec as ic


# ------------------------------------------------------------------- codec


def test_decode_length_id_and_wide():
    assert ic.decode_length(ic.MT.ID, 0) == 64
    assert ic.decode_length(ic.MT.ID, 1) == 72
    assert ic.decode_length(ic.MT.ISCC, 0, subtype=ic.ST_ISCC.WIDE) == 256


def test_decode_units_rejects_out_of_range():
    with pytest.raises(ValueError, match="invalid unit composition"):
        ic.decode_units(99)


def test_encode_base32_empty_is_empty():
    assert ic.encode_base32(b"") == ""


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7])
def test_encode_base32_matches_stdlib_all_tail_shapes(n):
    """Odd/even output-length tails (the table encoder emits pairs, then one
    trailing char when nchars is odd) — pinned to the stdlib encoding."""
    data = bytes(range(1, n + 1))
    expected = base64.b32encode(data).decode().rstrip("=")
    assert ic.encode_base32(data) == expected
    assert ic.decode_base32(expected) == data


def test_decode_base64_rejects_impossible_length():
    # NB: stdlib b64decode (validate=False) silently drops non-alphabet
    # characters, so "garbage" inputs often decode to b"" — only a data
    # length impossible for base64 reaches the error path.
    with pytest.raises(ValueError, match="invalid base64"):
        ic.decode_base64("A")


def test_gen_iscc_id_rejects_bad_realm_and_server():
    with pytest.raises(ValueError, match="realm_id"):
        ic.gen_iscc_id_v1(server_id=0, realm_id=2)
    with pytest.raises(ValueError, match="server_id"):
        ic.gen_iscc_id_v1(server_id=4096)


# ----------------------------------------------------------------- packing


def test_pack_code_single_roundtrip():
    from iscc_search_tpu.ops.packing import pack_code, unpack_code

    body = bytes(range(16))
    lanes, nlanes = pack_code(body)
    assert nlanes == 4
    assert unpack_code(lanes, nlanes) == body


# -------------------------------------------------------------------- topk


def test_topk_scan_rejects_unknown_metric():
    import jax.numpy as jnp

    from iscc_search_tpu.ops.topk import topk_scan_impl

    q = jnp.zeros((1, 2), jnp.uint32)
    ql = jnp.ones(1, jnp.int32)
    db = jnp.zeros((4, 2), jnp.uint32)
    dl = jnp.ones(4, jnp.int32)
    valid = jnp.ones(4, bool)
    with pytest.raises(ValueError, match="unknown metric"):
        topk_scan_impl(q, ql, db, dl, valid, k=2, chunk_size=4, metric="cosine")


# ------------------------------------------------------------ memory index


def test_memory_search_index_deleted_mid_expansion(monkeypatch):
    """An index deleted between query expansion (outside the lock) and the
    snapshot read must 404, not KeyError."""
    from iscc_search_tpu.indexes import common
    from iscc_search_tpu.indexes.memory.index import MemoryIndex
    from iscc_search_tpu.schema import IsccIndex, IsccQuery

    idx = MemoryIndex()
    idx.create_index(IsccIndex(name="gone"))

    real = common.expand_iscc_id_query

    def deleting_expand(query, getter):
        idx.delete_index("gone")
        return real(query, getter)

    monkeypatch.setattr(common, "expand_iscc_id_query", deleting_expand)
    code = ic.gen_iscc_code_v0(
        [
            ic.encode_component(ic.MT.DATA, 0, 0, 64, bytes(range(8))),
            ic.encode_component(ic.MT.INSTANCE, 0, 0, 64, bytes(range(8, 16))),
        ]
    )["iscc"]
    with pytest.raises(FileNotFoundError):
        idx.search_assets("gone", IsccQuery(iscc_code=code))


def test_metadata_from_asset_bytes_rejects_non_dict_metadata():
    from iscc_search_tpu.indexes.common import metadata_from_asset_bytes

    with pytest.raises(RuntimeError, match="not an object"):
        metadata_from_asset_bytes(b'{"metadata": [1, 2]}')
    with pytest.raises(RuntimeError, match="corrupt stored asset record"):
        metadata_from_asset_bytes(b"[]")  # record itself is not an object


def test_wide_composite_with_wrong_body_length_rejected():
    from iscc_search_tpu.models import IsccCode

    header = ic.encode_header(ic.MT.ISCC, ic.ST_ISCC.WIDE, ic.VS.V0, ic.encode_units(()))
    code = "ISCC:" + ic.encode_base32(header + bytes(16))  # WIDE needs 32
    with pytest.raises(ValueError, match="WIDE composite"):
        IsccCode(code).units


# ---------------------------------------------------------------- managers


def test_kv_manager_list_skips_corrupt_and_foreign_entries(tmp_path, caplog):
    from iscc_search_tpu.indexes.kv.manager import KvIndexManager
    from iscc_search_tpu.schema import IsccIndex

    mgr = KvIndexManager(tmp_path)
    mgr.create_index(IsccIndex(name="good"))
    (tmp_path / "notanindex").mkdir()          # dir without the .kv suffix
    (tmp_path / "stray.kv").write_bytes(b"")   # .kv FILE, not a dir
    bad = tmp_path / "bad.kv"
    bad.mkdir()
    (bad / "data.tstore").write_bytes(b"\x00" * 7)  # unloadable store
    with caplog.at_level("WARNING"):
        names = [i.name for i in mgr.list_indexes()]
    assert "good" in names
    assert "notanindex" not in names and "stray" not in names
    mgr.close()


def test_kv_manager_delete_uncached_index(tmp_path):
    from iscc_search_tpu.indexes.kv.manager import KvIndexManager
    from iscc_search_tpu.schema import IsccIndex

    mgr = KvIndexManager(tmp_path)
    mgr.create_index(IsccIndex(name="victim"))
    mgr.close()  # drop the cache; the dir stays

    mgr2 = KvIndexManager(tmp_path)
    mgr2.delete_index("victim")  # never loaded into mgr2's cache
    assert not (tmp_path / "victim.kv").exists()
    mgr2.close()


def test_tpu_manager_delete_uncached_index(tmp_path):
    from iscc_search_tpu.indexes.tpu.manager import TpuIndexManager
    from iscc_search_tpu.schema import IsccIndex

    mgr = TpuIndexManager(tmp_path)
    mgr.create_index(IsccIndex(name="victim"))
    mgr.close()

    mgr2 = TpuIndexManager(tmp_path)
    mgr2.delete_index("victim")
    assert not (tmp_path / "victim").exists()
    mgr2.close()


# ----------------------------------------------------- options/config/cli


def test_get_index_memory_uri_with_suffix():
    from iscc_search_tpu.indexes.memory.index import MemoryIndex
    from iscc_search_tpu.options import get_index

    idx = get_index("memory://anything")
    assert isinstance(idx, MemoryIndex)
    idx.close()


def test_add_remote_without_use_keeps_active(tmp_path):
    from iscc_search_tpu.config import ConfigManager

    mgr = ConfigManager(config_dir=tmp_path)
    mgr.add_remote("first", "http://a", "main")
    mgr.add_remote("second", "http://b", "main", use=False)
    assert mgr.config.active == "first"


def test_parse_simprints_skips_feature_with_empty_simprints():
    from iscc_search_tpu.cli.common import parse_simprints_from_features

    out = parse_simprints_from_features(
        [{"maintype": "content", "subtype": "text", "version": 0, "simprints": []}]
    )
    assert out is None



# ---------------------------------------------------------------- kv index


def test_kv_update_keeps_retained_units_and_unitless_assets(tmp_path, entry_factory):
    from iscc_search_tpu.indexes.kv.index import KvIndex
    from iscc_search_tpu.schema import IsccEntry, IsccQuery

    idx = KvIndex(tmp_path / "i.kv")
    try:
        e = entry_factory(bits=64)
        idx.add_assets([IsccEntry(**e)])

        # Update dropping the META/CONTENT units but RETAINING data+instance:
        # the retained units' rows must survive (the `in new_units: continue`
        # path), the dropped ones must stop matching.
        kept = e["units"][-2:]
        idx.add_assets([IsccEntry(iscc_id=e["iscc_id"], iscc_code=e["iscc_code"], units=kept)])
        res = idx.search_assets(IsccQuery(units=kept))
        assert [m.iscc_id for m in res.global_matches] == [e["iscc_id"]]
        dropped = e["units"][0]
        res2 = idx.search_assets(IsccQuery(units=[dropped, kept[0]]))
        [m] = res2.global_matches
        assert m.types.get("CONTENT_TEXT_V0", 0) == 0 or "CONTENT_TEXT_V0" not in m.types

        # An asset carrying no units at all indexes (store row only) and a
        # query with no units returns no matches instead of dividing by zero.
        e2 = entry_factory(bits=64)
        idx.add_assets([IsccEntry(iscc_id=e2["iscc_id"], iscc_code=e2["iscc_code"])])
        assert idx.get_asset(e2["iscc_id"]).iscc_id == e2["iscc_id"]
    finally:
        idx.close()
