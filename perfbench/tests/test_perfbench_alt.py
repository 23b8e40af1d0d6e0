"""Reference assemblies of several contigs with ALT haplotypes, and traffic
drawn from named regions: a tiny assembly runs end to end on the port's CPU
route against the plain reference, with bwa's ALT-aware mapping at work;
the one-contig form and traffic without regions give the same bytes as
before."""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest
from perfbench_tiny import ROOT, tiny_root

from perfbench import check, genome as genome_mod, harness, traffic as traffic_mod
from perfbench.reference.records import RECORD_FIELDS

REGION = (100_000, 130_000)
ALT_CONFIG = {
    "name": "tiny-alt",
    "genome": {"contigs": [
        {"name": "chrT", "length": 300_000, "seed": 1234},
        {"name": "chrT_alt1_alt", "seed": 1,
         "alt_of": {"contig": "chrT", "start": REGION[0], "end": REGION[1]},
         "snv": 0.01, "indel": 0.001},
        {"name": "chrT_alt2_alt", "seed": 2,
         "alt_of": {"contig": "chrT", "start": REGION[0], "end": REGION[1]},
         "snv": 0.01, "indel": 0.001},
    ]},
}
ALT_CELLS = {"tiny.alt.pe": ("tiny-pe150-k10m", "tiny-alt-pe150"),
             "tiny.alt.se": ("tiny-se150-k10m", "tiny-alt-se150")}
# about 80 % of the pairs from the region and its two haplotypes
REGIONS = [
    {"contig": "chrT", "start": 0, "end": 300_000, "weight": 0.2},
    {"contig": "chrT", "start": REGION[0], "end": REGION[1], "weight": 0.4},
    {"contig": "chrT_alt1_alt", "start": 0, "end": 29_000, "weight": 0.2},
    {"contig": "chrT_alt2_alt", "start": 0, "end": 29_000, "weight": 0.2},
]

# sha256 of the one-contig form's tiny genome (the ``ecoli-k12``
# configuration at 300,000 bases), its cache file and index image, and of
# the first two batches of each traffic file's pool (run seed 2**31 + 11)
# and its work sample on it, as the benchmark made them before
# configurations could list contigs and traffic could name regions
BEFORE = {
    "genome": "b91640f757091aab72a9f10af7f238aa62c63be4ff08cac79a01ca7b1830bba6",
    "genome.npy": "a414d6d6f78ef3683dfce03b6de72ec52056eddb69b740adff5bb8b921936e2a",
    "ref.img": "d54337d1885ad3c2e483b390bd9eb851d960e41b3de5e9afcc26a2042b57ea9b",
    "pe150-k10m": ("3ef0ce1eba99632124cf9886104a4471e9aa79d011aa38c596690133821e30f9",
                   "601d0f61986e9186ca3942c3acd7fb4a8d00570e38a33f6e78e2ac5135730527"),
    "pe150-k1m": ("8fbecc9a3fff05be7c9c4863a1599b0a969788bcc5eff6af602d0c8e1b223987",
                  "b5445847386da64df983a92effe0069d5a434f396154e0398bf8cffd655c7c0e"),
    "se150-k10m": ("c950661fa4a7eb89e7b55dc776829a063552bb79aa40dfcc97aa59a697611282",
                   "e9254478eff9493225ac5b046dcdb8fdf3b4b52ff1aa6eab6eebd9c27487378e"),
}


def _sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _file_sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny cells' root with the ALT cells added, as a later change
    would add them: a configuration file, traffic files, entries."""
    root = tiny_root(tmp_path_factory.mktemp("alt"), sample=32)
    with open(os.path.join(root, "perfbench/configs/tiny.json")) as f:
        cfg = json.load(f)
    cfg.update(ALT_CONFIG)
    with open(os.path.join(root, "perfbench/configs/tiny-alt.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append(dict(name="tiny-alt", source="https://example.org",
                                file="perfbench/configs/tiny-alt.json",
                                reduced=["contigs"], why="CPU tests"))
    for cell, (tiny, traffic) in ALT_CELLS.items():
        with open(os.path.join(root, f"perfbench/traffic/{tiny}.json")) as f:
            tr = json.load(f)
        tr["regions"] = REGIONS
        with open(os.path.join(root, f"perfbench/traffic/{traffic}.json"),
                  "w") as f:
            json.dump(tr, f)
        spec["workloads"].append(dict(name=cell, config="tiny-alt",
                                      traffic=traffic, chips=1,
                                      why="CPU tests"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and "tiny.pe" in m["workloads"]:
            m["workloads"] += list(ALT_CELLS)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


@pytest.fixture(scope="module")
def alt_runs(root):
    """One run of each ALT cell on the CPU route, with the sample that was
    held against the reference."""
    runs = {}
    compare = check.compare
    for cell in ALT_CELLS:
        def keep(sample, *a, **k):
            runs[cell] = sample
            return compare(sample, *a, **k)

        check.compare = keep
        try:
            result = harness.run_cell(harness.load_cell(cell, root),
                                      2**31 + 17, 0.5, False, device="cpu")
        finally:
            check.compare = compare
        runs[cell] = (result, runs[cell])
    return runs


@pytest.mark.parametrize("cell", list(ALT_CELLS))
def test_the_alt_cell_is_correct(alt_runs, cell):
    result, sample = alt_runs[cell]
    assert result["forbidden_modules"] == []
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"]["sampled_reads_differing"] == dict(value=0, limit=0)
    assert len(sample.units()) == 32
    assert result["checks"]["sampled_reads_compared"]["value"] == (
        64 if cell == "tiny.alt.pe" else 32)


@pytest.mark.parametrize("cell", list(ALT_CELLS))
def test_the_alt_path_was_exercised(alt_runs, cell):
    """Reads that match the haplotypes as well as the primary region name
    them in XA; reads whose best hit is on a haplotype get a record there
    (a supplementary one: bwa reports the primary assembly's hit first).
    In pairs, the port and the reference alike report a proper pair's ALT
    hits in XA alone."""
    _, sample = alt_runs[cell]
    ref_id = RECORD_FIELDS.index("ref_id")
    xa_tag = RECORD_FIELDS.index("xa_tag")
    records = [rec for _, _, reads in sample.units() for recs in reads
               for rec in recs]
    assert any(rec[xa_tag] and "_alt," in rec[xa_tag] for rec in records)
    on_alt = [rec for rec in records if rec[ref_id] in (1, 2)]
    if cell == "tiny.alt.se":
        assert on_alt and all(rec[0] & 0x800 for rec in on_alt)


def test_the_image_flags_the_configurations_alt_contigs(root, alt_runs):
    from bwamem_tpu_torch.index import image

    cache = os.path.join(root, "perfbench", ".cache", "tiny-alt")
    idx = image.read_image(os.path.join(cache, "ref.img"))
    names = [c["name"] for c in ALT_CONFIG["genome"]["contigs"]]
    assert [a.name for a in idx.bns.anns] == names
    assert [a.is_alt for a in idx.bns.anns] == [0, 1, 1]
    with open(os.path.join(cache, "ref.alt")) as f:
        assert f.read().split() == names[1:]
    genome = genome_mod.load(ALT_CONFIG, cache)
    assert genome.alt == frozenset(names[1:])
    assert [a.is_alt for a in check.reference_index(genome, "cpu").anns] \
        == [0, 1, 1]


def test_an_alt_haplotype_is_a_diverged_copy_of_its_region():
    region = genome_mod.synthetic_genome(100_000, np.random.default_rng(7))
    snv = genome_mod.alt_haplotype(region, 0.01, 0.0, np.random.default_rng(1))
    assert len(snv) == len(region)
    assert 0.008 < np.mean(snv != region) < 0.012
    assert (snv[region > 3] == region[region > 3]).all()
    indel = genome_mod.alt_haplotype(region, 0.0, 0.001,
                                     np.random.default_rng(1))
    assert indel.tobytes() != region.tobytes()
    assert abs(len(indel) - len(region)) < 1_000
    assert indel.tobytes() == genome_mod.alt_haplotype(
        region, 0.0, 0.001, np.random.default_rng(1)).tobytes()


def test_regions_keep_each_pair_inside_its_region(root):
    genome = genome_mod.load(ALT_CONFIG, os.path.join(root, "alt-cache"))
    tr = dict(read_len=150, insert_mean=350, insert_std=35, error_rate=0.0)
    regions = [dict(contig="chrT", start=50_000, end=51_200, weight=1.0)]
    src = traffic_mod.Regions(regions, genome, tr)
    codes = traffic_mod.simulate(src, np.random.default_rng(5), 200, tr)
    text = genome["chrT"][50_000:51_200].tobytes()
    for q in codes[0::2]:
        assert q.tobytes() in text
    for q in codes[1::2]:
        assert (3 - q[::-1]).tobytes() in text
    with pytest.raises(ValueError):
        traffic_mod.source(dict(tr), genome)


def test_the_one_contig_form_makes_the_same_genome_and_image(tmp_path):
    with open(os.path.join(ROOT, "perfbench/configs/ecoli-k12.json")) as f:
        cfg = json.load(f)
    cfg["genome"]["length"] = 300_000
    cache = str(tmp_path)
    genome = genome_mod.load(cfg, cache)
    assert [n for n, _ in genome.contigs] == ["NC_000913.3"] and not genome.alt
    assert _sha(genome.contigs[0][1]) == BEFORE["genome"]
    assert _file_sha(os.path.join(cache, "genome.npy")) == BEFORE["genome.npy"]
    harness._open_index(cfg, genome, cache).close()
    assert _file_sha(os.path.join(cache, "ref.img")) == BEFORE["ref.img"]
    assert not os.path.exists(os.path.join(cache, "ref.alt"))


@pytest.mark.parametrize("name", ["pe150-k10m", "pe150-k1m", "se150-k10m"])
def test_traffic_without_regions_draws_as_before(name):
    codes = genome_mod.synthetic_genome(300_000, np.random.default_rng(1234))
    genome = genome_mod.Genome([("NC_000913.3", codes)])
    with open(os.path.join(ROOT, f"perfbench/traffic/{name}.json")) as f:
        tr = json.load(f)
    pool = traffic_mod.make_pool(tr, genome, 2**31 + 11)
    assert (_sha(*[b.codes for b in pool[:2]]),
            _sha(traffic_mod.work_units(tr, genome))) == BEFORE[name]
