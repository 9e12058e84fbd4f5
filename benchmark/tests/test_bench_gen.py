"""The seeded generators: sizes fixed by the configuration, bases by the
seed."""

import json
import os

import numpy as np
import pytest

from benchmark import gen

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)["genomes"]


def test_equal_cluster_sizes():
    n = gen.cluster_sizes(102400, 128)
    assert n.sum() == 102400 and set(n.tolist()) == {800}
    n = gen.cluster_sizes(10, 4)
    assert n.tolist() == [3, 3, 2, 2]


def test_the_configuration_fixes_the_sizes():
    c = _config("synth100k_s12")
    g = gen.make_genomes(dict(c, G=256, clusters=2, length=1000), 5, "cpu")
    assert (np.diff(g.offsets) == 1000).all()
    assert np.bincount(g.cluster).tolist() == [128, 128]


TINY = {"G": 40, "clusters": 4, "length": 300, "mutation": 0.02}


def test_genomes_are_determined_by_the_seed():
    a = gen.make_genomes(TINY, 7, "cpu")
    b = gen.make_genomes(TINY, 7, "cpu")
    c = gen.make_genomes(TINY, 8, "cpu")
    assert (a.codes == b.codes).all() and a.names == b.names
    assert (a.offsets == c.offsets).all()    # the same work for every seed
    assert (a.codes != c.codes).mean() > 0.5
    assert a.codes.max() <= 3 and a.G == 40 and a.names[0] == "c0_g00"


def test_descendants_carry_the_mutation_rate():
    cfg = dict(TINY, G=64, clusters=1, length=5000)
    g = gen.make_genomes(cfg, 123, "cpu")
    rows = g.codes.reshape(64, 5000)
    consensus = np.array([np.bincount(col, minlength=4).argmax()
                          for col in rows.T])
    # the replacement base is uniform, the same base included
    assert abs((rows != consensus).mean() - 0.015) < 0.002


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 2**40 + 3])
def test_large_seeds(seed):
    g = gen.make_genomes(TINY, seed, "cpu")
    q, src = gen.make_queries(g, 5, 0.01, seed, "cpu")
    assert q.G == 5 and src.max() < g.G
    assert [len(q.seq(i)) for i in range(5)] == \
        [len(g.seq(s)) for s in src]


def test_queries_are_mutants_of_their_source():
    g = gen.make_genomes(dict(TINY, length=2000), 3, "cpu")
    q, src = gen.make_queries(g, 8, 0.01, 3, "cpu")
    q2, src2 = gen.make_queries(g, 8, 0.01, 3, "cpu")
    assert (src == src2).all() and (q.codes == q2.codes).all()
    for i, s in enumerate(src):
        assert (q.seq(i) != g.seq(s)).mean() < 0.03


def test_fasta_files_hold_the_codes(tmp_path):
    g = gen.make_genomes(TINY, 5, "cpu")
    path = tmp_path / "all.fa"
    assert g.write_fasta(str(path)) == g.bases
    lines = path.read_bytes().split(b"\n")
    assert lines[0] == b">c0_g00"
    assert lines[1] == gen.ASCII[g.seq(0)].tobytes()
    gz = tmp_path / "all.fa.gz"
    assert g.write_fasta(str(gz), gz=True) == g.bases
    import gzip
    assert gzip.decompress(gz.read_bytes()) == path.read_bytes()
    paths = g.write_each(str(tmp_path / "each"))
    assert open(paths[3], "rb").read() == \
        b">%s\n%s\n" % (g.names[3].encode(), gen.ASCII[g.seq(3)].tobytes())
