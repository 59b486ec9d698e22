"""Sample-app golden tests — the BASELINE config #1-#4 bit-exactness anchors
(reference sample apps double as CI smoke tests; SURVEY.md §3.5/§4.4).

Each test runs a CLI subcommand on the bundled data/ inputs and compares the
entire stdout to the committed golden file; any semantic drift in kernels,
tie-breaks, sort orders or filters fails these first.
"""

from claragenomicsanalysis_tpu.bench.samples import golden, run_case


def test_sample_align_golden():
    assert run_case("align")


def test_sample_poa_golden():
    assert run_case("poa")


def test_sample_poa_msa_golden():
    assert run_case("poa_msa")


def test_sample_map_golden():
    assert run_case("map")


def test_sample_map_query_vs_target_golden():
    assert run_case("map_qt")


def test_sample_pipeline_golden():
    assert run_case("pipeline")


def test_pipeline_cigars_are_exact():
    """cg:Z spans must re-derive: CIGAR ops consume exactly the PAF spans."""
    import re
    for line in golden("pipeline").splitlines():
        cols = line.split("\t")
        cg = [c for c in cols if c.startswith("cg:Z:")]
        assert cg, line
        qspan = int(cols[3]) - int(cols[2])
        tspan = int(cols[8]) - int(cols[7])
        qc = tc = 0
        for num, op in re.findall(r"(\d+)([MID])", cg[0][5:]):
            n = int(num)
            if op in "MI":
                qc += n
            if op in "MD":
                tc += n
        assert qc == qspan and tc == tspan, line


def test_sample_correct_golden():
    """BASELINE config #5 anchor: the read-correction CLI end-to-end on the
    bundled reads, byte-for-byte (map -> windows -> POA polish)."""
    assert run_case("correct")
