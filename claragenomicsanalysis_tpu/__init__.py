"""claragenomicsanalysis_tpu — a long-read sequence-analysis engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
ClaraGenomicsAnalysis (NVIDIA's CUDA genomics library; reference fork
r-mafi/ClaraGenomicsAnalysis):

- ``models.aligner``  — batched pairwise global alignment (banded NW /
  Myers bit-vector / Hirschberg), emitting CIGARs.
  Reference parity target: ``cudaaligner/`` [U].
- ``models.poa``      — batched partial-order alignment (consensus + MSA)
  as a dense-graph DP over padded node arrays.
  Reference parity target: ``cudapoa/`` [U].
- ``models.mapper``   — all-vs-all minimizer overlap mapping
  (sketch -> sorted index -> anchors -> chains -> PAF).
  Reference parity target: ``cudamapper/`` [U].
- ``parallel``        — device-mesh sharding (data / rep / sp axes) built on
  ``jax.sharding`` + ``shard_map`` (the reference has no distributed
  backend; this is new capability).

Design stance (see SURVEY.md §7): everything static-shape, padded, and
status-coded; batch-of-problems is the dominant parallel axis; Pallas is
the native kernel layer; CPU NumPy oracles define exact semantics.

Paths cited as ``reference: <path> [U]`` refer to the reference tree layout
reconstructed in SURVEY.md (the mount was empty; see its provenance note).
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API (keeps `import claragenomicsanalysis_tpu` free of
    jax initialization): the reference-parity surfaces re-exported."""
    import importlib
    lazy = {
        "create_aligner": ("claragenomicsanalysis_tpu.models.aligner",
                           "create_aligner"),
        "Aligner": ("claragenomicsanalysis_tpu.models.aligner", "Aligner"),
        "Alignment": ("claragenomicsanalysis_tpu.models.aligner",
                      "Alignment"),
        "create_batch": ("claragenomicsanalysis_tpu.models.poa",
                         "create_batch"),
        "Batch": ("claragenomicsanalysis_tpu.models.poa", "Batch"),
        "Index": ("claragenomicsanalysis_tpu.models.mapper", "Index"),
        "Matcher": ("claragenomicsanalysis_tpu.models.mapper", "Matcher"),
        "Overlapper": ("claragenomicsanalysis_tpu.models.mapper",
                       "Overlapper"),
        "map_all_vs_all": ("claragenomicsanalysis_tpu.models.mapper",
                           "map_all_vs_all"),
        "run_pipeline": ("claragenomicsanalysis_tpu.models.pipeline",
                         "run_pipeline"),
        "correct_reads": ("claragenomicsanalysis_tpu.models.correct",
                          "correct_reads"),
        "CorrectConfig": ("claragenomicsanalysis_tpu.core.config",
                          "CorrectConfig"),
        "create_fasta_parser": ("claragenomicsanalysis_tpu.io.fasta",
                                "create_fasta_parser"),
        "AlignerConfig": ("claragenomicsanalysis_tpu.core.config",
                          "AlignerConfig"),
        "BatchSize": ("claragenomicsanalysis_tpu.core.config", "BatchSize"),
        "PoaScores": ("claragenomicsanalysis_tpu.core.config", "PoaScores"),
        "MapperConfig": ("claragenomicsanalysis_tpu.core.config",
                         "MapperConfig"),
        "PipelineConfig": ("claragenomicsanalysis_tpu.core.config",
                           "PipelineConfig"),
        "StatusType": ("claragenomicsanalysis_tpu.core.status",
                       "StatusType"),
        "AlignmentType": ("claragenomicsanalysis_tpu.core.status",
                          "AlignmentType"),
        "AlignmentState": ("claragenomicsanalysis_tpu.core.status",
                           "AlignmentState"),
        "OutputType": ("claragenomicsanalysis_tpu.core.status",
                       "OutputType"),
    }
    if name in lazy:
        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
