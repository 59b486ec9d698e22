"""Status codes and alignment-state enums.

Mirrors the per-problem soft-error discipline of the reference
(reference: cudaaligner/include/claragenomics/cudaaligner/cudaaligner.hpp [U],
cudapoa/include/claragenomics/cudapoa/cudapoa.hpp [U]): a batch never hard-fails
because one problem overflowed a static limit — the problem gets a status code
and the rest of the batch proceeds.  Here this discipline is load-bearing:
every array is statically shaped and padded, so "does not fit" MUST become a
status, not an exception, to keep the XLA program shape-stable.
"""

import enum


class StatusType(enum.IntEnum):
    """Per-problem status. Union of the aligner and POA status enums of the
    reference (values are our own; the reference's numeric values are not API).
    """

    SUCCESS = 0
    UNINITIALIZED = 1
    GENERIC_ERROR = 2
    # aligner
    EXCEEDED_MAX_ALIGNMENTS = 10
    EXCEEDED_MAX_LENGTH = 11
    EXCEEDED_MAX_ALIGNMENT_DIFFERENCE = 12  # band overflow (banded NW)
    # poa
    EXCEEDED_MAXIMUM_POAS = 20
    EXCEEDED_MAXIMUM_SEQUENCE_SIZE = 21
    EXCEEDED_MAXIMUM_SEQUENCES_PER_POA = 22
    NODE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE = 23
    EDGE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE = 24
    SEQ_LEN_EXCEEDED_MAXIMUM_NODES = 25
    LOOP_COUNT_EXCEEDED_UPPER_BOUND = 26
    OUTPUT_TYPE_UNAVAILABLE = 27
    EXCEEDED_BAND_WIDTH = 28  # banded graph-NW: no global path inside band
    # mapper
    EXCEEDED_MAX_ANCHORS = 30
    EXCEEDED_MAX_OVERLAPS = 31


class AlignmentType(enum.IntEnum):
    GLOBAL_ALIGNMENT = 0


class AlignmentState(enum.IntEnum):
    """Edit-path op codes, used for traceback arrays and CIGAR conversion.

    Orientation convention (SAM): the *query* is aligned against the *target*;
    INSERTION consumes a query base, DELETION consumes a target base.

    Canonical tie-break for all NW implementations (oracle and device kernels
    alike): prefer MATCH/MISMATCH (diagonal), then DELETION (target-consuming),
    then INSERTION.  This is OUR canonical rule (documented, deterministic);
    all implementations in this package must agree bit-for-bit.
    """

    MATCH = 0
    MISMATCH = 1
    INSERTION = 2   # consumes query
    DELETION = 3    # consumes target


class OutputType(enum.IntFlag):
    """POA batch output selection (reference: cudapoa.hpp OutputType [U])."""

    CONSENSUS = 1
    MSA = 2


#: CIGAR op letter per AlignmentState in compact (M/I/D) form — matches the
#: reference's convert_to_cigar which folds match+mismatch into 'M'
#: (reference: cudaaligner/src/alignment_impl.cpp [U]).
CIGAR_OP_COMPACT = {0: "M", 1: "M", 2: "I", 3: "D"}
#: Extended (=/X/I/D) form.
CIGAR_OP_EXTENDED = {0: "=", 1: "X", 2: "I", 3: "D"}
