"""PyTorch port, the C++ host data plane (mixmogam_tpu_torch/native.py and
the data layer's routes through it): the sources pinned to the JAX
package's, and on the same files the port's native route, its Python
route and the JAX package give the same containers and the same packed
bytes (exact equality)."""

import gzip
import pathlib
import struct
import zlib

import numpy as np
import pytest
import torch

from mixmogam_tpu import native as jnative
from mixmogam_tpu.data import parsers as jparsers
from mixmogam_tpu.data import simulate as jsim
from mixmogam_tpu.data import vcf as jvcf
from mixmogam_tpu_torch import native
from mixmogam_tpu_torch.data import genotype, pack2, parsers, vcf
from mixmogam_tpu_torch.ops.pack2 import pack_2bit_device
from test_parser_fuzz import JUNK, VCF_JUNK

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _same_gd(a, b):
    assert type(a).__name__ == type(b).__name__
    assert a.matrix.dtype == b.matrix.dtype
    np.testing.assert_array_equal(a.matrix, b.matrix)
    np.testing.assert_array_equal(a.chromosomes, b.chromosomes)
    np.testing.assert_array_equal(a.positions, b.positions)
    assert a.accessions == b.accessions and a.ploidy == b.ploidy
    assert (a.alleles is None) == (b.alleles is None)
    if a.alleles is not None:
        np.testing.assert_array_equal(a.alleles, b.alleles)


# ---- the library ----------------------------------------------------------

@pytest.mark.parametrize("name", ["fast_parse.cpp", "fast_vcf.cpp"])
def test_host_sources_are_copies(name):
    port = ROOT / "mixmogam_tpu_torch" / "csrc" / "host" / name
    assert port.read_bytes() == (ROOT / "native" / name).read_bytes()


def test_library_builds_from_the_port_into_kernels():
    assert native.available(), native.BUILD_LOG
    port = ROOT / "mixmogam_tpu_torch"
    assert [pathlib.Path(s).parent for s in native.SOURCES] == [
        port / "csrc" / "host"] * 2
    lib = pathlib.Path(native.get_lib()._name)
    assert lib.parent == port / "_kernels"
    assert lib.name.startswith("libfastparse-") and lib.suffix == ".so"
    for sym in ("count_csv", "parse_dosage_csv", "packed_row_bytes",
                "pack_2bit", "unpack_2bit", "vcf_open", "vcf_next",
                "vcf_close"):
        assert hasattr(native.get_lib(), sym)
    assert native.get_lib().packed_row_bytes(9) == 3


def test_library_name_keys_on_sources_and_flags(monkeypatch):
    a = native._lib_path("g++ 1")
    assert native._lib_path("g++ 2") != a
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-g"])
    assert native._lib_path("g++ 1") != a


def test_no_compiler_takes_the_python_route(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "LIB_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert native.get_lib() is None and not native.available()
    assert "no-such-compiler" in native.BUILD_LOG
    G = np.array([[0, 1, 2, -1, 1]], np.int8)
    np.testing.assert_array_equal(native.unpack_2bit(
        native.pack_2bit(G), 5), G)
    assert list(tmp_path.iterdir()) == []


# ---- 2-bit packing ------------------------------------------------------

@pytest.mark.parametrize("n,missing", [(1, 0.0), (3, 0.2), (4, 0.0),
                                       (5, 0.1), (37, 0.05), (64, 0.3)])
def test_pack_routes_are_bit_equal(n, missing):
    rng = np.random.default_rng(n)
    G = rng.integers(0, 3, (41, n)).astype(np.int8)
    G[rng.random(G.shape) < missing] = -1
    P = pack2.pack_2bit(G)
    assert P.shape == (41, (n + 3) // 4) and P.dtype == np.uint8
    np.testing.assert_array_equal(P, pack2._pack_numpy(G))
    np.testing.assert_array_equal(P, jnative.pack_2bit(G))
    np.testing.assert_array_equal(P, native.pack_2bit(G))
    np.testing.assert_array_equal(
        P, pack_2bit_device(torch.from_numpy(G)).numpy())
    for un in (pack2.unpack_2bit(P, n), pack2._unpack_numpy(P, n, chunk=7),
               native.unpack_2bit(P, n), jnative.unpack_2bit(P, n)):
        assert un.dtype == np.int8
        np.testing.assert_array_equal(un, G)


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("bad", [
    np.array([[0, 3]], np.int8), np.array([[0, -2]], np.int16),
    np.array([[0.5, 1.0]]), np.array([[np.nan, 1.0]]),
    np.array([[2.7, 0.0]], np.float32)], ids=range(5))
def test_pack_refuses_before_the_cast(bad, route, monkeypatch):
    if route == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(ValueError):
        jnative.pack_2bit(bad)
    with pytest.raises(ValueError):
        pack2.pack_2bit(bad)


@pytest.mark.parametrize("route", ["native", "python"])
def test_unpack_refuses_rows_of_another_width(route, monkeypatch):
    if route == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    P = pack2.pack_2bit(np.zeros((3, 9), np.int8))
    for n in (8, 13, 100):
        with pytest.raises(ValueError, match="samples"):
            pack2.unpack_2bit(P, n)
    with pytest.raises(ValueError, match="samples"):
        pack2.unpack_2bit(P[0], 9)


def test_pack_takes_integral_floats():
    G = np.array([[0.0, 1.0, 2.0, -1.0, 1.0]])
    np.testing.assert_array_equal(pack2.pack_2bit(G),
                                  jnative.pack_2bit(G))


# ---- dosage CSV -----------------------------------------------------------

@pytest.mark.parametrize("ploidy,missing,n", [(1, 0.0, 1), (1, 0.05, 23),
                                              (2, 0.08, 64), (2, 0.0, 5)])
def test_dosage_csv_routes_match_jax(tmp_path, ploidy, missing, n,
                                     monkeypatch):
    G, ch, po = jsim.simulate_genotypes(n, 180, ploidy=ploidy,
                                        missing_rate=missing, seed=n)
    gd = genotype.GenotypeData(G, ch, po, [f"s{i}" for i in range(n)],
                               ploidy=ploidy)
    p = str(tmp_path / "g.csv")
    gd.write_csv(p)
    assert native.parse_dosage_csv(p) is not None   # the native route
    got = parsers.parse_snp_data(p)
    ref = jparsers.parse_snp_data(p)
    _same_gd(got, ref)
    np.testing.assert_array_equal(got.matrix, G)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    _same_gd(parsers.parse_snp_data(p), ref)
    _same_gd(parsers.parse_snp_data(p, ploidy=2),
             jparsers.parse_snp_data(p, ploidy=2))


def test_dosage_csv_edge_tokens(tmp_path, monkeypatch):
    """Missing spellings, padded cells, negatives, a blank line and CRLF
    endings on the port's Python route, against the JAX package's
    parse."""
    monkeypatch.setattr(native, "get_lib", lambda: None)
    body = ("Chromosome,Position,a, b ,c,d\r\n"
            "1,10,0, NA,-,2\r\n"
            "\n"
            "2, 20 ,-5,?, 1 ,nan\r\n"
            "3,30,NaN,N,,1\n")
    p = tmp_path / "e.csv"
    p.write_text(body)
    py = parsers.parse_snp_data(str(p))
    ref = jparsers.parse_snp_data(str(p))
    _same_gd(py, ref)
    np.testing.assert_array_equal(py.matrix, [[0, -1, -1, 2],
                                              [-1, -1, 1, -1],
                                              [-1, -1, -1, 1]])


def test_dosage_csv_edge_tokens_native(tmp_path):
    body = ("Chromosome,Position,a,b\n"
            "1,10,0, NA\n"
            "   \n"
            "2,20,-5,1")
    p = str(tmp_path / "e.csv")
    with open(p, "w") as f:
        f.write(body)
    assert native.parse_dosage_csv(p) is not None
    _same_gd(parsers.parse_snp_data(p), jparsers.parse_snp_data(p))


# ---- VCF ------------------------------------------------------------------

_HEAD = ("##fileformat=VCFv4.2\n"
         "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t")


def _vcf_text(case: str, n: int = 37, m: int = 150, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    samples = [f"s{i}" for i in range(n)]
    lines = [_HEAD + "\t".join(samples) + "\n"]
    if case == "empty":
        return lines[0]
    calls = np.array(["0/0", "0|1", "1/1", "./.", "1", ".", "./1"])
    if case == "multiallelic":
        calls = np.append(calls, ["0/2", "2|1", "1/2", "3/3"])
    names = ["chr1", "2", "chrX", "scaffold_7"]
    if case == "long_chrom":
        names[3] = "this_chromosome_name_is_long"
    for j in range(m):
        alt = "G,T" if case == "multiallelic" and j % 3 == 0 else "G"
        row = rng.choice(calls, n, p=None)
        fmt, row = ("GT:DP", [c + ":7" for c in row]) if j % 5 == 0 \
            else ("GT", list(row))
        lines.append(f"{names[j * 4 // m]}\t{100 + j}\trs{j}\tA\t{alt}\t.\t"
                     f".\t.\t{fmt}\t" + "\t".join(row) + "\n")
    text = "".join(lines)
    if case == "crlf":
        text = text.replace("\n", "\r\n")
    return text


def _bgzip(data: bytes, block: int = 4096) -> bytes:
    """BGZF: gzip members of at most `block` input bytes, each with the
    'BC' extra field holding its size, and the empty end-of-file block."""
    out = []
    for s in range(0, len(data), block):
        piece = data[s:s + block]
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        cdata = co.compress(piece) + co.flush()
        out.append(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                   + struct.pack("<HBBHH", 6, 66, 67, 2,
                                 len(cdata) + 25)
                   + cdata + struct.pack("<II", zlib.crc32(piece),
                                         len(piece)))
    return b"".join(out) + bytes.fromhex(
        "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _write(tmp_path, text: str, form: str) -> str:
    data = text.encode()
    if form == "plain":
        p = tmp_path / "c.vcf"
        p.write_bytes(data)
    else:
        p = tmp_path / "c.vcf.gz"
        p.write_bytes(gzip.compress(data) if form == "gzip"
                      else _bgzip(data))
    return str(p)


_CASES = ["basic", "crlf", "multiallelic", "long_chrom", "empty"]


@pytest.mark.parametrize("form", ["plain", "gzip", "bgzip"])
@pytest.mark.parametrize("case", _CASES)
def test_read_vcf_routes_match_jax(tmp_path, case, form, monkeypatch):
    p = _write(tmp_path, _vcf_text(case), form)
    # the native parser refuses a chromosome name over 15 characters:
    # the Python route takes that file
    assert (vcf._read_vcf_native(p) is None) == (case == "long_chrom")
    got, cmap = vcf.read_vcf(p, return_chrom_map=True)
    ref, jcmap = jvcf.read_vcf(p, return_chrom_map=True)
    _same_gd(got, ref)
    assert cmap == jcmap
    if case != "empty":
        assert got.num_snps == 150 and (got.matrix == -1).any()
        assert got.accessions[-1] == "s36"
    monkeypatch.setattr(native, "get_lib", lambda: None)
    py, pcmap = vcf.read_vcf(p, return_chrom_map=True)
    _same_gd(py, ref)
    assert pcmap == jcmap


@pytest.mark.parametrize("form", ["plain", "gzip", "bgzip"])
@pytest.mark.parametrize("case", _CASES)
def test_read_vcf_packed_routes_match_jax(tmp_path, case, form,
                                          monkeypatch):
    p = _write(tmp_path, _vcf_text(case), form)
    kw = dict(tile=64, chunk_rows=41)
    rg, meta = vcf.read_vcf_packed(p, device="cpu", **kw)
    jrg, jmeta = jvcf.read_vcf_packed(p, **kw)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    prg, pmeta = vcf.read_vcf_packed(p, device="cpu", **kw)
    for r, m_ in ((rg, meta), (prg, pmeta)):
        np.testing.assert_array_equal(r.host_packed, jrg.host_packed)
        assert torch.equal(r.packed, torch.from_numpy(jrg.host_packed))
        assert (r.M, r.n, r.ploidy, r.has_missing, r.tile) == (
            jrg.M, jrg.n, jrg.ploidy, jrg.has_missing, jrg.tile)
        assert m_["accessions"] == jmeta["accessions"]
        assert m_["chrom_map"] == jmeta["chrom_map"]
        for k in ("chromosomes", "positions"):
            np.testing.assert_array_equal(m_[k], jmeta[k])
        assert (m_["alleles"] is None) == (jmeta["alleles"] is None)
        if jmeta["alleles"] is not None:
            np.testing.assert_array_equal(m_["alleles"], jmeta["alleles"])


@pytest.mark.parametrize("route", ["native", "python"])
def test_read_vcf_packed_refuses_polyploid(tmp_path, monkeypatch, route):
    text = (_HEAD + "a\tb\n"
            "1\t10\t.\tA\tG\t.\t.\t.\tGT\t0/1/1/1\t0/0/0/0\n")
    p = _write(tmp_path, text, "plain")
    if route == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(ValueError, match="polyploid"):
        vcf.read_vcf_packed(p, device="cpu")


def test_native_chunks_match_one_chunk(tmp_path):
    p = _write(tmp_path, _vcf_text("basic", m=150), "bgzip")
    whole = native.parse_vcf(p, 37)
    chunks = list(native.iter_vcf(p, 37, chunk_rows=16))
    assert [c[0].shape[0] for c in chunks] == [16] * 9 + [6]
    np.testing.assert_array_equal(np.vstack([c[0] for c in chunks]),
                                  whole[0])
    ref = jnative.parse_vcf(p, 37)
    for a, b in zip(whole, ref):
        np.testing.assert_array_equal(a, b)


def test_native_vcf_arena_regrows(tmp_path):
    """REF / ALT strings longer than the arena's 64 bytes a row: the
    parser answers -3 and the iterator grows the arena and asks again."""
    ref_allele = "ACGT" * 40
    text = _HEAD + "a\tb\n" + "".join(
        f"1\t{10 + j}\t.\t{ref_allele}\tG\t.\t.\t.\tGT\t0/1\t1/1\n"
        for j in range(5))
    p = _write(tmp_path, text, "plain")
    chunks = list(native.iter_vcf(p, 2, chunk_rows=2))
    assert [c[0].shape[0] for c in chunks] == [2, 2, 1]
    assert all((c[4][:, 0] == ref_allele).all() for c in chunks)
    _same_gd(vcf.read_vcf(p), jvcf.read_vcf(p))


def test_iter_vcf_header_disagreement_raises(tmp_path):
    p = _write(tmp_path, _vcf_text("basic", n=3, m=4), "plain")
    with pytest.raises(RuntimeError, match="sample count"):
        list(native.iter_vcf(p, 4))
    assert native.parse_vcf(p, 4) is None


# ---- the JAX fuzz payloads -----------------------------------------------

def _outcome(fn):
    try:
        return fn()
    except (ValueError, OverflowError, UnicodeDecodeError) as exc:
        return type(exc)


@pytest.mark.parametrize("kind,payload", [("csv", p) for p in JUNK]
                         + [("vcf", p) for p in VCF_JUNK],
                         ids=[f"csv{i}" for i in range(len(JUNK))]
                         + [f"vcf{i}" for i in range(len(VCF_JUNK))])
def test_fuzz_payload_refused_or_equal_to_jax(tmp_path, kind, payload,
                                              monkeypatch):
    p = str(tmp_path / f"junk.{kind}")
    with open(p, "wb") as f:
        f.write(payload)
    if kind == "csv":
        readers = [(parsers.parse_snp_data, jparsers.parse_snp_data)]
    else:
        readers = [(vcf.read_vcf, jvcf.read_vcf),
                   (lambda q: vcf.read_vcf_packed(q, device="cpu")[0],
                    lambda q: jvcf.read_vcf_packed(q)[0])]
    for port_fn, jax_fn in readers:
        ref = _outcome(lambda: jax_fn(p))
        for route in ("native", "python"):
            with monkeypatch.context() as mp:
                if route == "python":
                    mp.setattr(native, "get_lib", lambda: None)
                got = _outcome(lambda: port_fn(p))
            if isinstance(ref, type):
                assert got is ref, (route, got, ref)
            elif hasattr(ref, "matrix"):
                assert got.matrix.shape == (len(got.chromosomes),
                                            len(got.accessions))
                _same_gd(got, ref)
            else:
                np.testing.assert_array_equal(got.host_packed,
                                              ref.host_packed)
                assert (got.M, got.n) == (ref.M, ref.n)
