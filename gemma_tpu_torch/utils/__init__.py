"""Quality gates and diagnostics: per-device peaks (`device`), spans,
counters and the roofline ledger (`profiling`), activation capture and
golden diffs (`tensor_dump`), perplexity (`perplexity`) and the on-device
kernel check (`verify`). Counterparts of `gemma_tpu/utils/`; import the
submodules (the model's forward imports `tensor_dump`, and `perplexity`
and `verify` import the model)."""
