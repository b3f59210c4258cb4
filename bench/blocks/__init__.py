"""Model blocks: everything the harness does that depends on a model's
equations, one module per block (``bench/blocks/<name>.py``).

A configuration file names its block under ``"block"``; without the key
it is ``moe_gqa`` (grouped-query attention, top-k softmax routing
renormalised over the chosen experts, SwiGLU experts: Mixtral and
Phi-3.5-MoE).  The harness loads the module by file path from the
benchmark directory in use (``benchlib.cell.load_block``), so a new block
is added as new files only.  A block module exposes:

``plain_spec(cfg) -> dict``
    The sizes and semantics that the reference and the FLOP count compute
    with, taken from the configuration file alone.  Always holds
    ``vocab_size``.

``port_config(cfg) -> repro_torch ModelConfig``
    The port's configuration with every size and setting from the file
    (none from the port's preset where the file states it).

``make_weights(spec, seed, device) -> dict``
    The parameter tree that the port's ``Model.init`` builds for
    ``port_config(cfg)``: the same keys, shapes and dtypes
    (``bench/tests/test_bench_weights.py`` holds every configuration file
    to it), drawn from `seed` alone on `device`, in the type the
    configuration serves.  The same tensors go to the program and to the
    reference.

``token_flops(spec, context)`` and ``chunk_flops(spec, start, n, *, head=False)``
    Model FLOPs of one decoded token attending to `context` keys, and of a
    prefill chunk of n tokens at positions start .. start + n - 1 (the head
    on its last token when `head`), counted from shapes; a multiply-add is
    2 FLOPs.  ``decode_mfu`` and ``prefill_mfu`` read them.

``smoke_config(cfg, **sizes) -> dict``
    For the CPU tests only (``bench/tests/``): the same configuration at
    widths a CPU test holds (same block, same semantics), so that those
    tests take every configuration file without an edit.  No run calls
    it.

``REFERENCE``
    The name of a module under ``bench/reference/`` with
    ``logits(weights, spec, tokens, n_prompt, *, fp8=False, first=None)``:
    the plain forward, teacher-forced, in float32 with TF32 off, giving the
    float32 logits at positions first .. T - 1; ``fp8=True`` is the
    control, one precision below the configuration's.  It imports nothing
    of the program (``test_bench_imports.py``) and works out again
    whatever the program derives from the weights.

The KV layout is not the block's: the file's ``"engine"`` block states it
(``paged_kv``, ``kv_page_size``, ``prefill_chunk``), and ``run_cell`` builds
the backend from it.  ``paged_kv: false`` admits through the engine's
one-shot dense-KV prefill (one ``join_step`` per admission, the whole
prompt), the layout a block that cannot page its cache (MLA) runs on.

A block module may import ``repro_torch`` (inside ``port_config``), never
JAX or the JAX package.
"""
