"""Model zoo of the port: plain functions on tensors, layers stacked on a
leading ``[L, ...]`` axis and walked by a Python loop.  One module per
family (``api.get_model``): ``transformer`` (dense, vlm), ``moe``,
``xlstm`` (ssm), ``hymba`` (hybrid), ``whisper`` (encdec).

    init(seed, cfg, device)                 -> Params (an nn.Module)
    forward(params, cfg, tokens, frames=/patches=) -> logits
    init_cache(cfg, batch, max_len, device) -> cache dict
    prefill(params, cfg, tokens, max_len)   -> (last logits, cache)
    decode_step(params, cfg, cache, tok, pos) -> (logits, cache)
"""
