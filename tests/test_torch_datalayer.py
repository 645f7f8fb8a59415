"""PyTorch port, the copied host layers (data, results, oracle kinship,
caches, config): each against its original in the JAX package on the same
inputs: equal arrays, and equal file bytes where the original is
deterministic. Files written by one package are read by the other."""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from mixmogam_tpu import config as jconfig
from mixmogam_tpu import native
from mixmogam_tpu.data import genotype as jgeno
from mixmogam_tpu.data import parsers as jparsers
from mixmogam_tpu.data import phenotype as jpheno
from mixmogam_tpu.data import plink as jplink
from mixmogam_tpu.data import simulate as jsim
from mixmogam_tpu.data import vcf as jvcf
from mixmogam_tpu.oracle import kinship as joracle
from mixmogam_tpu.results import ld as jld
from mixmogam_tpu.results import mtcorr as jmt
from mixmogam_tpu.results import result as jresult
from mixmogam_tpu.utils import caching as jcache
from mixmogam_tpu_torch import config, convert
from mixmogam_tpu_torch.data import (genotype, pack2, parsers, phenotype,
                                     plink, vcf)
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.ops.pack2 import pack_2bit_device
from mixmogam_tpu_torch.oracle import kinship as oracle
from mixmogam_tpu_torch.results import ld, mtcorr, result
from mixmogam_tpu_torch.utils import caching

torch.set_num_threads(1)


def _pair(n=41, m=200, ploidy=2, missing=0.04, seed=5, alleles=False):
    """The same genotypes in both packages' containers. Asymmetric on
    purpose: allele frequencies far from 1/2, so swapped codes show."""
    G, ch, po = jsim.simulate_genotypes(n, m, ploidy=ploidy,
                                        missing_rate=missing, seed=seed)
    acc = [f"s{i:03d}" for i in range(n)]
    al = None
    if alleles:
        rng = np.random.default_rng(seed)
        al = np.array([rng.permutation(list("ACGT"))[:2] for _ in range(m)])
    kw = dict(matrix=G, chromosomes=ch, positions=po, accessions=acc,
              ploidy=ploidy, alleles=al)
    return jgeno.GenotypeData(**kw), genotype.GenotypeData(**kw)


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


# ---- 2-bit packing ------------------------------------------------------

@pytest.mark.parametrize("n", [1, 3, 4, 5, 150, 153])
def test_numpy_pack_matches_native_and_device(n):
    rng = np.random.default_rng(n)
    G = rng.integers(-1, 3, (29, n)).astype(np.int8)
    P = pack2.pack_2bit(G)
    np.testing.assert_array_equal(P, native.pack_2bit(G))
    np.testing.assert_array_equal(
        P, pack_2bit_device(torch.from_numpy(G)).numpy())
    np.testing.assert_array_equal(pack2.unpack_2bit(P, n), G)
    np.testing.assert_array_equal(pack2.unpack_2bit(P, n),
                                  native.unpack_2bit(P, n))


@pytest.mark.parametrize("bad", [
    np.array([[0, 3]], np.int8), np.array([[0.5, 1.0]]),
    np.array([[np.nan, 1.0]])])
def test_numpy_pack_refuses_what_native_refuses(bad):
    with pytest.raises(ValueError):
        native.pack_2bit(bad)
    with pytest.raises(ValueError):
        pack2.pack_2bit(bad)


# ---- GenotypeData -------------------------------------------------------

@pytest.mark.parametrize("ploidy,missing", [(1, 0.0), (2, 0.05)])
def test_content_hash_and_statistics(ploidy, missing):
    jg, g = _pair(ploidy=ploidy, missing=missing)
    assert g.content_hash() == jg.content_hash()
    np.testing.assert_array_equal(g.get_macs(), jg.get_macs())
    np.testing.assert_array_equal(g.get_mafs(), jg.get_mafs())
    np.testing.assert_array_equal(g.dosage_f64(), jg.dosage_f64())
    for a, b in ((g.filter_mac_snps(6), jg.filter_mac_snps(6)),
                 (g.filter_maf_snps(0.1), jg.filter_maf_snps(0.1)),
                 (g.filter_monomorphic_snps(), jg.filter_monomorphic_snps()),
                 (g.select_samples([5, 0, 7]), jg.select_samples([5, 0, 7])),
                 (g.get_region(1, 0, 10**7), jg.get_region(1, 0, 10**7))):
        _same_gd(a, b)
        assert a.content_hash() == b.content_hash()


def test_content_hash_carries_through_convert():
    """A cache key computed by either package names the same entry."""
    jg, g = _pair(alleles=True)
    assert convert.genotype_from_fields(jg).content_hash() == \
        jg.content_hash() == g.content_hash()
    _same_gd(convert.genotype_from_fields(jg), jg)


def test_dosage_data_matches():
    rng = np.random.default_rng(1)
    D = rng.uniform(0, 2, (60, 17)).astype(np.float32)
    D[rng.random(D.shape) < 0.05] = np.nan
    kw = dict(matrix=D, chromosomes=np.ones(60), positions=np.arange(60),
              accessions=[f"a{i}" for i in range(17)], ploidy=2)
    jd, d = jgeno.DosageData(**kw), genotype.DosageData(**kw)
    assert d.content_hash() == jd.content_hash()
    np.testing.assert_array_equal(d.dosage_f64(), jd.dosage_f64())
    for a, b in zip(d.allele_counts(), jd.allele_counts()):
        np.testing.assert_array_equal(a, b)
    _same_gd(d.filter_mac_snps(3), jd.filter_mac_snps(3))
    _same_gd(convert.genotype_from_fields(jd), jd)
    with pytest.raises(NotImplementedError):
        d.write_csv("x")
    with pytest.raises(NotImplementedError):
        d.write_packed("x")


def test_coordinate_with_phenotype_matches():
    jg, g = _pair()
    rng = np.random.default_rng(2)
    ecos = [jg.accessions[i] for i in rng.permutation(41)[:30]] + ["zz"]
    ecos += ecos[:5]                                   # replicates
    vals = rng.normal(size=len(ecos))
    vals[3] = np.nan
    jp = jpheno.PhenotypeData.from_arrays(1, "t", ecos, vals)
    p = phenotype.PhenotypeData.from_arrays(1, "t", ecos, vals)
    (ja, jy, jids), (a, y, ids) = (jg.coordinate_with_phenotype(jp, 1),
                                   g.coordinate_with_phenotype(p, 1))
    _same_gd(a, ja)
    np.testing.assert_array_equal(y, jy)
    assert ids == jids
    # and across packages: the port's genotypes with the JAX phenotypes
    b, y2, ids2 = g.coordinate_w_phenotype_data(jp, 1)
    _same_gd(b, ja)
    np.testing.assert_array_equal(y2, jy)


# ---- files written by one package, read by the other --------------------

@pytest.mark.parametrize("ploidy,missing", [(1, 0.0), (2, 0.05)])
def test_csv_round_trips_across_packages(tmp_path, ploidy, missing):
    jg, g = _pair(ploidy=ploidy, missing=missing)
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    jg.write_csv(a)
    g.write_csv(b)
    assert filecmp.cmp(a, b, shallow=False)
    # the port's Python parser against the JAX package's (C++ or Python)
    _same_gd(parsers.parse_snp_data(a, ploidy=ploidy),
             jparsers.parse_snp_data(b, ploidy=ploidy))
    _same_gd(parsers.parse_snp_data(b), jparsers.parse_snp_data(a))


@pytest.mark.parametrize("chunk_bytes", [None, 1 << 16])
def test_csv_chunks_are_sized_by_bytes(tmp_path, monkeypatch, chunk_bytes):
    """write_csv formats csv_chunk_rows(n) rows a chunk: 64 MiB at 16 bytes
    a cell (4 Mi cells, not the JAX package's 64 M). On a matrix the step
    cuts into several chunks (the real constant: two, the second partial;
    a 64 KiB chunk: three of four rows or fewer), missing calls among
    them, the file is byte-equal to the JAX package's, which writes it in
    one chunk."""
    if chunk_bytes is not None:
        monkeypatch.setattr(genotype, "CSV_CHUNK_BYTES", chunk_bytes)
    n = 1_024
    step = genotype.csv_chunk_rows(n)
    assert step == (64 << 20) // (16 * n) if chunk_bytes is None else 4
    jg, g = _pair(n=n, m=step + 7, ploidy=2, missing=0.02, seed=9)
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    jg.write_csv(a)
    g.write_csv(b)
    assert filecmp.cmp(a, b, shallow=False)


def test_csv_parser_edge_tokens(tmp_path):
    f = tmp_path / "e.csv"
    f.write_text("Chromosome,Position,a,b,c,d\n1,10,0,NA,2,-5\n"
                 "\n2,20, 1 ,,N,1\n")
    got = parsers.parse_snp_data(str(f))
    jgot = jparsers.parse_snp_data(str(f))
    _same_gd(got, jgot)
    np.testing.assert_array_equal(got.matrix,
                                  [[0, -1, 2, -1], [1, -1, -1, 1]])


@pytest.mark.parametrize("ploidy", [None, 1, 2])
def test_nucleotide_csv_matches(tmp_path, ploidy):
    f = tmp_path / "nt.csv"
    f.write_text(
        "Chromosome,Position,s1,s2,s3,s4,s5,s6,s7\n"
        "1,100,A,A,G,G,A,N,A\n"
        "1,200,A,A,A,GT,GT,GT,GT\n"
        "1,300,AT,A/T,T|T,R,NN,C,A\n"
        "2,50,C,C,C,T,T,Y,-\n")
    got = parsers.parse_snp_data(str(f), data_format="nucleotides",
                                 ploidy=ploidy)
    ref = jparsers.parse_snp_data(str(f), data_format="nucleotides",
                                  ploidy=ploidy)
    _same_gd(got, ref)


def _asymmetric():
    """Genotypes on which a swapped .bed code table cannot pass: every
    code has its own count and hom-minor is rare."""
    rng = np.random.default_rng(11)
    G = rng.choice(np.array([0, 1, 2, -1], np.int8), size=(157, 23),
                   p=[0.62, 0.25, 0.08, 0.05])
    kw = dict(matrix=G, chromosomes=np.repeat([1, 2, 7], [50, 50, 57]),
              positions=np.arange(157) * 13 + 5,
              accessions=[f"id{i}" for i in range(23)], ploidy=2,
              alleles=np.array([["A", "G"]] * 157))
    return jgeno.GenotypeData(**kw), genotype.GenotypeData(**kw)


def test_plink_round_trips_across_packages(tmp_path):
    jg, g = _asymmetric()
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jplink.write_plink(a, jg)
    plink.write_plink(b, g)
    for ext in (".bed", ".bim", ".fam"):
        assert filecmp.cmp(a + ext, b + ext, shallow=False), ext
    np.testing.assert_array_equal(plink._LUT, jplink._LUT)
    np.testing.assert_array_equal(plink._INV_LUT, jplink._INV_LUT)
    _same_gd(plink.read_plink(a), jplink.read_plink(b + ".bed"))
    np.testing.assert_array_equal(plink.read_plink(a).matrix, g.matrix)
    _same_gd(parsers.parse_snp_data(a + ".bed"),
             jparsers.parse_snp_data(b, data_format="plink"))
    src, ch, po, ids = plink.read_plink(b, lazy=True)
    jsrc = jplink.read_plink(a, lazy=True)[0]
    idx = np.array([150, 3, 3, 0])
    np.testing.assert_array_equal(src[idx], jsrc[idx])
    np.testing.assert_array_equal(src[7], jsrc[7])
    np.testing.assert_array_equal(src.packed_rows(slice(0, 157)),
                                  jsrc.packed_rows(slice(0, 157)))
    np.testing.assert_array_equal(np.asarray(src), g.matrix)
    for got, ref in zip(plink.read_bim(a + ".bim"),
                        jplink.read_bim(a + ".bim")):
        np.testing.assert_array_equal(got, ref)


def test_read_bim_contig_codes_match(tmp_path):
    f = tmp_path / "c.bim"
    f.write_text("chr1 a 0 5 A G\nX b 0 6 A G\nscaf_9 c 0 7 A G\n"
                 "31 d 0 8 A G\nscaf_2 e 0 9 A G\nscaf_9 f 0 10 A G\n"
                 "short line\n")
    for got, ref in zip(plink.read_bim(str(f)), jplink.read_bim(str(f))):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("tile", [64, 200])
def test_resident_from_plink_recodes_on_the_device(tmp_path, tile):
    """The .bed bytes re-coded on the device equal the container packed
    from the decoded genotypes, and the JAX package's LUT remap on every
    sample slot (it leaves the tail slots of the last byte at .bed's
    zero bits; the port writes code 3 there, as from_source does)."""
    jg, g = _asymmetric()
    a = str(tmp_path / "a")
    plink.write_plink(a, g)
    rg, ch, po, ids = plink.resident_from_plink(a, tile=tile, device="cpu")
    ref = ResidentGenome.from_source(g, tile=tile, device="cpu")
    np.testing.assert_array_equal(rg.host_packed, ref.host_packed)
    assert (rg.M, rg.n, rg.ploidy, rg.has_missing) == (157, 23, 2, True)
    assert rg.content_key() == ref.content_key()
    np.testing.assert_array_equal(rg[0:157], g.matrix)
    jrg = jplink.resident_from_plink(a, tile=tile)[0]
    np.testing.assert_array_equal(rg[0:157], jrg[0:157])
    np.testing.assert_array_equal(rg.host_packed[:, :-1],
                                  jrg.host_packed[:, :-1])
    raw = torch.arange(256, dtype=torch.uint8)[None, :]
    np.testing.assert_array_equal(plink.recode_bed_bytes(raw).numpy()[0],
                                  jplink._LUT)
    # fully observed fileset: has_missing must come out False
    full = genotype.GenotypeData(np.where(g.matrix < 0, 0, g.matrix),
                                 g.chromosomes, g.positions, g.accessions,
                                 ploidy=2)
    plink.write_plink(a, full)
    assert not plink.resident_from_plink(a, device="cpu")[0].has_missing


def test_plink_device_default_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    _, g = _asymmetric()
    plink.write_plink(str(tmp_path / "a"), g)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        plink.resident_from_plink(str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        vcf.read_vcf_packed(str(tmp_path / "nothing.vcf"))


@pytest.mark.parametrize("gz", [False, True])
def test_vcf_round_trips_across_packages(tmp_path, gz):
    jg, g = _pair(ploidy=2, missing=0.05, alleles=True)
    ext = ".vcf.gz" if gz else ".vcf"
    a, b = str(tmp_path / ("a" + ext)), str(tmp_path / ("b" + ext))
    jvcf.write_vcf(jg, a, chrom_names={1: "chr1", 5: "X"})
    vcf.write_vcf(g, b, chrom_names={1: "chr1", 5: "X"})
    if not gz:                      # gzip stamps its header with the time
        assert filecmp.cmp(a, b, shallow=False)
    got, cmap = vcf.read_vcf(a, return_chrom_map=True)
    ref, jcmap = jvcf.read_vcf(b, return_chrom_map=True)
    _same_gd(got, ref)
    assert cmap == jcmap
    _same_gd(parsers.parse_snp_data(a), jparsers.parse_snp_data(b))
    for x, y in zip(vcf._iter_vcf_python(a, chunk_rows=64),
                    jvcf._iter_vcf_python(a, chunk_rows=64)):
        assert x[0] == y[0] and x[3] == y[3] and x[5] == y[5]
        np.testing.assert_array_equal(x[1], y[1])


def test_vcf_dosages_and_odd_records_match(tmp_path):
    f = tmp_path / "d.vcf"
    f.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\ts2\ts3\r\n"
        "chr2\t10\t.\tA\tC\t.\t.\t.\tGT:DS\t0/1:0.9\t1|1:1.8\t./.:.\n"
        "scaf\t20\t.\tG\tT,C\t.\t.\t.\tGT:DS\t0/2:1.1,0.2\t0:0.1\t1/1\n"
        "7\t30\t.\tG\tT\t.\t.\t.\tGT\t0/0\t./1\t1/1\n")
    _same_gd(vcf.read_vcf(str(f)), jvcf.read_vcf(str(f)))
    for ploidy in (None, 2):
        _same_gd(vcf.read_vcf(str(f), field="DS", ploidy=ploidy),
                 jvcf.read_vcf(str(f), field="DS", ploidy=ploidy))
    _same_gd(parsers.parse_snp_data(str(f), data_format="vcf_ds"),
             jparsers.parse_snp_data(str(f), data_format="vcf_ds"))
    with pytest.raises(ValueError, match="unsupported FORMAT"):
        vcf.read_vcf(str(f), field="GP")
    with pytest.raises(ValueError, match="conflicts"):
        vcf.read_vcf(str(f), field="DS", ploidy=1)


def test_read_vcf_packed_matches(tmp_path):
    jg, g = _pair(n=37, m=300, ploidy=2, missing=0.03, alleles=True)
    a = str(tmp_path / "a.vcf")
    vcf.write_vcf(g, a)
    rg, meta = vcf.read_vcf_packed(a, tile=128, chunk_rows=77, device="cpu")
    jrg, jmeta = jvcf.read_vcf_packed(a, tile=128, chunk_rows=77)
    np.testing.assert_array_equal(rg.host_packed, jrg.host_packed)
    assert (rg.M, rg.n, rg.ploidy, rg.has_missing, rg.tile) == (
        jrg.M, jrg.n, jrg.ploidy, jrg.has_missing, jrg.tile)
    assert rg.content_key() == jrg.content_key()
    assert meta["accessions"] == jmeta["accessions"]
    assert meta["chrom_map"] == jmeta["chrom_map"]
    for k in ("chromosomes", "positions", "alleles"):
        np.testing.assert_array_equal(meta[k], jmeta[k])


def test_packed_and_hdf5_containers_cross(tmp_path):
    jg, g = _pair(ploidy=2, missing=0.05)
    a, b = str(tmp_path / "a.packed"), str(tmp_path / "b.packed")
    jg.write_packed(a)
    g.write_packed(b)
    with np.load(a + ".npz") as za, np.load(b + ".npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k])
    _same_gd(genotype.GenotypeData.read_packed(a),
             jgeno.GenotypeData.read_packed(b))
    ha, hb = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    jg.write_hdf5(ha)
    g.write_hdf5(hb)
    _same_gd(genotype.GenotypeData.read_hdf5(ha),
             jgeno.GenotypeData.read_hdf5(hb))
    _same_gd(parsers.parse_snp_data(ha), jparsers.parse_snp_data(hb))
    with pytest.raises(ValueError, match="conflicts"):
        parsers.parse_snp_data(ha, ploidy=1)
    D = g.dosage_f64().astype(np.float32)
    d = genotype.DosageData(D, g.chromosomes, g.positions, g.accessions, 2)
    d.write_hdf5(ha)
    got, ref = (genotype.GenotypeData.read_hdf5(ha),
                jgeno.GenotypeData.read_hdf5(ha))
    assert isinstance(got, genotype.DosageData)
    _same_gd(got, ref)


# ---- PhenotypeData ------------------------------------------------------

def _phen_pair(seed=0):
    rng = np.random.default_rng(seed)
    ecos = [f"e{i % 40}" for i in range(55)]
    v1 = rng.gamma(2.0, 1.5, 55)
    v2 = rng.normal(size=55)
    v2[[4, 9]] = np.nan
    out = []
    for mod in (jpheno, phenotype):
        p = mod.PhenotypeData()
        p.add_phenotype(1, "gamma", ecos, v1)
        p.add_phenotype(2, "normal", ecos, v2)
        out.append(p)
    return out


@pytest.mark.parametrize("trans", phenotype.TRANSFORMATIONS)
@pytest.mark.parametrize("pid", [1, 2])
def test_transforms_match(trans, pid):
    jp, p = _phen_pair()
    assert p.transform(pid, trans) == jp.transform(pid, trans)
    np.testing.assert_array_equal(p.get_values(pid), jp.get_values(pid))
    assert p.shapiro_wilk(pid) == jp.shapiro_wilk(pid)
    p.revert_to_raw_values(pid)
    jp.revert_to_raw_values(pid)
    np.testing.assert_array_equal(p.get_values(pid), jp.get_values(pid))


def test_most_normal_and_averages_match():
    assert phenotype.TRANSFORMATIONS == jpheno.TRANSFORMATIONS
    jp, p = _phen_pair(3)
    assert p.most_normal_transformation(1) == \
        jp.most_normal_transformation(1)
    np.testing.assert_array_equal(p.get_values(1), jp.get_values(1))
    assert p.value_dict(2) == jp.value_dict(2)
    p.convert_to_averages()
    jp.convert_to_averages()
    p.filter_ecotypes(1, [f"e{i}" for i in range(0, 40, 3)])
    jp.filter_ecotypes(1, [f"e{i}" for i in range(0, 40, 3)])
    for pid in (1, 2):
        assert p.get_ecotypes(pid) == jp.get_ecotypes(pid)
        np.testing.assert_array_equal(p.get_values(pid), jp.get_values(pid))
    q = convert.phenotype_from_fields(jp)
    assert q.phenotype_ids() == jp.phenotype_ids()
    assert q.value_dict(1) == jp.value_dict(1)
    assert q.phen_dict[1].transformation == jp.phen_dict[1].transformation


def test_phenotype_files_cross(tmp_path):
    jp, p = _phen_pair(4)
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    jp.write_to_file(a)
    p.write_to_file(b)
    assert filecmp.cmp(a, b, shallow=False)
    got = phenotype.PhenotypeData.parse_phenotype_file(a)
    ref = jpheno.PhenotypeData.parse_phenotype_file(b)
    assert got.phenotype_ids() == ref.phenotype_ids()
    for pid in got.phenotype_ids():
        assert got.get_name(pid) == ref.get_name(pid)
        assert got.value_dict(pid) == ref.value_dict(pid)
    f = tmp_path / "crlf.csv"
    f.write_bytes(b"ecotype_id,x,y\r\na,1.5,NA\r\nb,2\r\n\r\nc,3,4,5\r\n")
    got = phenotype.PhenotypeData.parse_phenotype_file(str(f))
    ref = jpheno.PhenotypeData.parse_phenotype_file(str(f))
    for pid in (1, 2):
        assert got.get_name(pid) == ref.get_name(pid)
        np.testing.assert_array_equal(got.get_values(pid),
                                      ref.get_values(pid))
    ha = str(tmp_path / "p.h5")
    p.write_hdf5(ha)
    back = jpheno.PhenotypeData.read_hdf5(ha)
    assert back.value_dict(2) == p.value_dict(2)


# ---- results ------------------------------------------------------------

def _result_pair(seed=0, m=400):
    rng = np.random.default_rng(seed)
    ps = rng.uniform(size=m) ** 3
    ps[[7, 70]] = ps[3]                                  # ties
    kw = dict(chromosomes=np.repeat([1, 2], m // 2),
              positions=np.tile(np.arange(m // 2) * 1000, 2),
              mafs=rng.uniform(0, 0.5, m), macs=rng.integers(1, 50, m))
    scan = {"ps": ps, "betas": rng.normal(size=m),
            "f_stats": rng.gamma(1, 1, m), "var_perc": rng.uniform(size=m)}
    return (jresult.Result.from_scan(scan, **kw),
            result.Result.from_scan(scan, **kw))


def test_result_files_and_queries_match(tmp_path):
    jr, r = _result_pair()
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    jr.write_to_file(a)
    r.write_to_file(b)
    assert filecmp.cmp(a, b, shallow=False)
    jr.write_to_file(a + ".pkl", only_pickled=True)
    back = result.Result.from_pickle(a + ".pkl")
    np.testing.assert_array_equal(back.scores, jr.get_top_snps(400).scores)
    for f in (lambda x: x.get_top_snps(9), lambda x: x.neg_log_trans(),
              lambda x: x.filter_attr("mafs", min_val=0.1, max_val=0.4),
              lambda x: x.filter_percentile(0.1),
              lambda x: x.get_region_result(2, 5000, 90000)):
        x, y = f(r), f(jr)
        assert x.score_type == y.score_type
        for k, v in x._all_arrays().items():
            np.testing.assert_array_equal(v, y._all_arrays()[k])
    assert r.arg_min_attr() == jr.arg_min_attr()
    assert r.min_score() == jr.min_score()
    genes = [result.Gene(1, 4000, 9000, "g1"), result.Gene(3, 1, 2, "g2"),
             result.Gene(2, 10**7, 10**7 + 5, "g3")]
    jgenes = [jresult.Gene(g.chromosome, g.start, g.stop, g.name)
              for g in genes]
    assert [g.name for g in r.get_genes_within(genes, 100)] == \
        [g.name for g in jr.get_genes_within(jgenes, 100)]
    np.testing.assert_array_equal(r.min_distances_to_genes(genes),
                                  jr.min_distances_to_genes(jgenes))
    gl = tmp_path / "genes.csv"
    gl.write_text("chromosome,start,stop,name\n1,4000,9000,g1\n\n2,5,6\n")
    assert result.load_gene_list(str(gl)) == [
        result.Gene(**vars(g)) for g in jresult.load_gene_list(str(gl))]
    q = convert.result_from_fields(jr)
    q.write_to_file(b)
    assert filecmp.cmp(a, b, shallow=False)


@pytest.mark.parametrize("seed", [0, 1])
def test_mtcorr_matches(seed):
    rng = np.random.default_rng(seed)
    ps = np.r_[rng.uniform(size=500), rng.uniform(size=10) * 1e-5]
    assert mtcorr.bonferroni_threshold(510) == jmt.bonferroni_threshold(510)
    assert mtcorr.get_bh_thres(ps) == jmt.get_bh_thres(ps)
    assert mtcorr.get_bhy_thres(ps) == jmt.get_bhy_thres(ps)
    assert mtcorr.get_bh_thres(np.ones(5)) == jmt.get_bh_thres(np.ones(5))


def test_ld_clumping_matches():
    jg, g = _pair(n=80, m=300, ploidy=2, missing=0.03, seed=9)
    rng = np.random.default_rng(9)
    ps = rng.uniform(size=300)
    ps[rng.choice(300, 25, replace=False)] *= 1e-5
    idx = np.array([5, 6, 7, 100, 250])
    np.testing.assert_array_equal(ld.ld_r2(g, idx), jld.ld_r2(jg, idx))
    kw = dict(p_threshold=1e-4, r2_threshold=0.2, window_bp=10**9)
    got = ld.clump_hits(ps, g, g.chromosomes, g.positions, **kw)
    ref = jld.clump_hits(ps, jg, jg.chromosomes, jg.positions, **kw)
    assert got == ref and len(got) > 0
    rg = ResidentGenome.from_source(g, tile=64, device="cpu")
    r = result.Result(ps, g.chromosomes, g.positions)
    assert r.clump(rg, **kw) == ref


# ---- oracle kinship, caches, config -------------------------------------

@pytest.mark.parametrize("ploidy,missing", [(1, 0.0), (1, 0.05), (2, 0.05)])
def test_oracle_kinship_copies(ploidy, missing):
    G, _, _ = jsim.simulate_genotypes(30, 250, ploidy=ploidy,
                                      missing_rate=missing, seed=4)
    Z = np.where(G < 0, np.nan, G.astype(np.float64))
    np.testing.assert_array_equal(oracle.mean_impute(Z),
                                  joracle.mean_impute(Z))
    Ki, Kv = (oracle.ibs_kinship(Z, ploidy=ploidy, chunk=64),
              oracle.vanraden_kinship(Z, ploidy=ploidy, chunk=64))
    np.testing.assert_array_equal(
        Ki, joracle.ibs_kinship(Z, ploidy=ploidy, chunk=64))
    np.testing.assert_array_equal(
        Kv, joracle.vanraden_kinship(Z, ploidy=ploidy, chunk=64))
    np.testing.assert_array_equal(oracle.scale_k(Ki), joracle.scale_k(Ki))
    acc = [f"a{i}" for i in range(30)]
    sub = [acc[i] for i in (9, 2, 29, 0)]
    np.testing.assert_array_equal(oracle.prepare_k(Kv, acc, sub),
                                  joracle.prepare_k(Kv, acc, sub))
    with pytest.raises(ValueError):
        oracle.ibs_kinship(Z, ploidy=3)


def test_kinship_cache_is_shared_by_both_packages(tmp_path):
    """A kinship cached by one package is a hit in the other: the same
    file name (content hash), the same npz fields."""
    jg, g = _pair(n=30, m=200, ploidy=1, missing=0.0)
    d1, d2 = str(tmp_path / "by_jax"), str(tmp_path / "by_port")
    Kj = jcache.cached_kinship(jg, "ibs", cache_dir=d1)
    Kp = caching.cached_kinship(g, "ibs", cache_dir=d2, device="cpu")
    assert sorted(os.listdir(d1)) == sorted(os.listdir(d2))
    np.testing.assert_array_equal(Kp, Kj)
    # poison each entry: a hit returns the poisoned matrix, a miss would
    # recompute the true one
    for d in (d1, d2):
        f = os.path.join(d, os.listdir(d)[0])
        caching.save_kinship_to_file(f, Kj + 1.0, g.accessions)
    np.testing.assert_array_equal(
        caching.cached_kinship(g, "ibs", cache_dir=d1, device="cpu"),
        Kj + 1.0)
    np.testing.assert_array_equal(
        jcache.cached_kinship(jg, "ibs", cache_dir=d2), Kj + 1.0)
    # a corrupt entry is recomputed and overwritten
    f = os.path.join(d2, os.listdir(d2)[0])
    with open(f, "wb") as fh:
        fh.write(b"not an npz")
    np.testing.assert_array_equal(
        caching.cached_kinship(g, "ibs", cache_dir=d2, device="cpu"), Kj)
    np.testing.assert_array_equal(caching.load_kinship_from_file(f)[0], Kj)
    assert not [x for x in os.listdir(d2) if ".tmp" in x]


def test_kinship_files_and_eigen_cache_cross(tmp_path):
    rng = np.random.default_rng(0)
    A = rng.normal(size=(25, 25))
    K = A @ A.T / 25
    acc = [f"a{i}" for i in range(25)]
    a, b = str(tmp_path / "a"), str(tmp_path / "b.npz")
    jcache.save_kinship_to_file(a, K, acc)
    caching.save_kinship_to_file(b, K, acc)
    for load in (caching.load_kinship_from_file,
                 jcache.load_kinship_from_file):
        for path in (a, b):
            Kb, accb = load(path)
            np.testing.assert_array_equal(Kb, K)
            assert accb == acc
    d = str(tmp_path / "eig")
    phi, U = caching.cached_eigen(K, cache_dir=d, device="cpu")
    jphi, jU = jcache.cached_eigen(K, cache_dir=d)        # the port's entry
    np.testing.assert_array_equal(phi, jphi)
    np.testing.assert_array_equal(U, jU)
    np.testing.assert_allclose((U * phi) @ U.T, K, atol=1e-12)
    assert phi[0] >= phi[-1] and U.dtype == np.float64
    phi2, _ = caching.cached_eigen(K, cache_dir=d, key="named", device="cpu")
    np.testing.assert_array_equal(phi2, phi)
    assert sorted(os.listdir(d))[-1] == "eigen_named.npz"


def test_cached_eigen_default_device_is_the_card_or_an_error(tmp_path,
                                                             monkeypatch):
    """Without a card and without device= cached_eigen raises and names
    device="cpu", even where the cache holds the entry: it never factors
    on the host by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    K = np.eye(6) + 0.1
    d = str(tmp_path / "eig")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        caching.cached_eigen(K, cache_dir=d)
    assert not os.path.exists(d)
    phi, U = caching.cached_eigen(K, cache_dir=d, device="cpu")
    np.testing.assert_allclose((U * phi) @ U.T, K, atol=1e-12)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        caching.cached_eigen(K, cache_dir=d)


def test_config_copy():
    """The REML, filter, mesh and precision defaults are the JAX package's;
    the scan tile is the port's own (emmax's default), not a TPU-sized
    figure."""
    import inspect

    from mixmogam_tpu_torch.models.emmax import emmax

    j, p = jconfig.DEFAULT, config.DEFAULT
    assert vars(p.reml) == vars(j.reml)
    assert vars(p.filters) == vars(j.filters)
    assert vars(p.mesh) == vars(j.mesh)
    assert vars(p.precision) == vars(j.precision)
    assert p.tiles.kinship_snp_block == j.tiles.kinship_snp_block
    assert p.tiles.scan_snp_tile == inspect.signature(
        emmax).parameters["tile"].default == 16_384
    c = convert.config_from_fields(jconfig.GwasConfig(
        reml=jconfig.RemlConfig(ngrids=50, esp=1e-4)))
    assert (c.reml.ngrids, c.reml.esp, c.reml.llim) == (50, 1e-4, -10.0)
    assert c.tiles.scan_snp_tile == 16_384
    assert json.dumps(vars(c.filters)) == json.dumps(vars(j.filters))
