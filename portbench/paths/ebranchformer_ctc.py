"""The program's serving path for the E-Branchformer CTC family, and the
readings that judge what it served: the Conformer CTC family's
(`paths/conformer_ctc.py`), whose request (`AsrModel.encode`,
`ctc_logits`, `ctc_greedy_decode`, the ids' copy to the host) and readings
of the CTC logits hold for any encoder. Only the reference differs
(`reference/ebranchformer_ctc.py`)."""

from portbench.paths.conformer_ctc import (  # noqa: F401
    build,
    control_readings,
    serve_readings,
    serve_request,
)
