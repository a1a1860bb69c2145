"""The plain reference against the port's exact engine, which is
byte-identical to pRIblast: the accessibility, the index and the search
of a small page. (The benchmark itself never runs the port's engines in
its reference; only this test holds the two together.)"""

import numpy as np
import pytest

from pbench import seqgen, traffic
from reference import index, jobs, search

P = dict(max_seed_length=20, hybrid_thr=-6.0, min_acc_len=5,
         interaction_thr=-4.0, final_thr=-8.0, dropout_wo_gap=5,
         dropout_w_gap=16, min_helix=3)


@pytest.mark.parametrize("n", [5, 7, 40, 73, 300])
def test_accessibility_matches_the_exact_engine(n):
    from priblast_tpu_torch.ops import native
    from priblast_tpu_torch.utils import alphabet

    seq = seqgen.markov_batch(np.random.default_rng(n), [n])[0].tobytes()
    seq = seq.decode()
    acc, cond = jobs.accessibility((seq, 70, 5))
    a, c = native.raccess(alphabet.access_codes(seq), 70, 5)
    assert len(acc) == max(n - 4, 0) and len(cond) == n
    assert np.abs(acc - a[: len(acc)]).max(initial=0) < 2e-5
    assert np.abs(cond - c).max(initial=0) < 2e-5


def test_index_matches_the_native_builders():
    from priblast_tpu_torch.ops import native
    from priblast_tpu_torch.utils import alphabet

    rng = np.random.default_rng(3)
    seqs = traffic.sequences(rng, rng.integers(1, 400, 40))
    enc = index.encode_page(seqs)
    assert (enc == alphabet.encode_db(seqs, 0)).all()
    sa = index.suffix_array(enc)
    assert (sa == native.sa_build(enc)).all()
    for got, want in zip(index.kmer_hash(enc, sa, 8),
                         native.kmer_hash(enc, sa, 8)):
        assert (got == want).all()


def test_search_gives_the_exact_engines_lines(tmp_path):
    from priblast_tpu_torch.models import db, ris
    from priblast_tpu_torch.utils.params import DbParams, RisParams

    rng = np.random.default_rng(5)
    ts = traffic.sequences(rng, [900, 1500, 700])
    qs = traffic.sequences(rng, [300, 500])
    traffic.write_fasta(tmp_path / "t.fa", [f"t{i}" for i in range(3)], ts)
    traffic.write_fasta(tmp_path / "q.fa", ["q0", "q1"], qs)
    db.run(DbParams(input=str(tmp_path / "t.fa"),
                    db_name=str(tmp_path / "db"), engine="exact"), threads=1)
    ris.run(RisParams(input=str(tmp_path / "q.fa"),
                      output=str(tmp_path / "out"),
                      db_name=str(tmp_path / "db"), engine="exact"),
            threads=1)
    want = []
    for line in (tmp_path / "out").read_text().splitlines()[3:]:
        f = line.split(",")
        want.append((f[1], f[3], f[8], float(f[7])))
    got = []
    acc_q = [jobs.accessibility((s, 70, 5)) for s in qs]
    acc_t = [jobs.accessibility((s, 70, 5)) for s in ts]
    for qi, q in enumerate(qs):
        for ti, t in enumerate(ts):
            for h in search.search_pair(q, t, *acc_q[qi], *acc_t[ti], P):
                a, b, c, d = h["first_last"]
                got.append((f"q{qi}", f"t{ti}", f"({a}-{b}:{c}-{d}) ",
                            h["energy"]))
    assert len(want) >= 4
    assert sorted(k[:3] for k in got) == sorted(k[:3] for k in want)
    by = {k[:3]: k[3] for k in want}
    for k in got:
        assert abs(by[k[:3]] - k[3]) < 2e-4


def test_bfloat16_rounds_to_eight_bits():
    x = np.array([1.0, 1.00390625, 1.005859375, 3.14159, -2.5e-3],
                 np.float32)
    r = search.bfloat16(x)
    assert r[0] == 1.0 and r[1] == 1.0  # a tie goes to even
    assert r[2] == 1.0078125
    assert abs(r[3] - 3.140625) < 1e-9
    assert search.bfloat16(2.0) == 2.0
    assert (jobs.bf16(x) == r.astype(np.float32)).all()
