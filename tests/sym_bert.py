"""BERT pretraining forward as an ``mx.sym`` graph, for either package.

``bert_symbol(S, ...)`` builds, from the symbol module ``S`` it is given
(``incubator_mxnet_torch.symbol`` or the JAX package's), the graph of
``BERTForPretrain(BERTModel(...))``'s forward: word and type embeddings,
positions as a ``slice_axis`` of the position table added by
``broadcast_add``, ``embed_ln``; per layer the fused QKV projection into
``contrib.fused_qkv_attention``, ``out``, ``ln1``, the GELU FFN and ``ln2``
(post-LN); the pooler (the first position through a tanh Dense) and
``nsp``; ``gather_positions`` of the masked positions, ``mlm_dense``,
GELU, ``mlm_ln`` and ``mlm_decoder``.  Dropout is left out: a served model
runs in inference.  The outputs are ``Group([mlm_logits, nsp_logits])``.

Every variable carries the Gluon parameter's name
(``<bert prefix>enc_layer0_attn_qkv_weight`` and so on), so
``{"arg:" + name: p.data()}`` of ``BERTForPretrain.collect_params()``,
saved with ``mx.nd.save``, is this graph's checkpoint.  ``names`` gives the
two Gluon prefixes, ``(BERTModel.prefix, BERTForPretrain.prefix)``.
``ffn_op_type`` makes each encoder layer's FFN activation
``S.Custom(h, op_type=ffn_op_type)``, a user's registered op (the default,
None, is the built-in GELU).

Imports neither package: tests and ``chip_smoke.py`` pass ``S`` in.
"""

DEFAULT_NAMES = ("bertmodel0_", "bertforpretrain0_")


def bert_symbol(S, num_layers, units, hidden_size, num_heads, vocab_size, seq_len,
                num_masked, names=DEFAULT_NAMES, max_length=512, ffn_op_type=None):
    """The symbol graph; its inputs are ``token_ids`` and ``token_types``
    ``[B, seq_len]`` int32 and ``masked_positions`` ``[B, num_masked]``
    int32.  ``max_length`` is the position table's row count (the Gluon
    model's ``max_length``): no op's rule derives it from the data."""
    bp, hp = names

    def dense(x, prefix, n_out, act=None):
        out = S.FullyConnected(x, S.var(prefix + "weight"), S.var(prefix + "bias"),
                               num_hidden=n_out, no_bias=False, flatten=False,
                               name=prefix + "fwd")
        if act is not None:
            out = S.Activation(out, act_type=act, name=prefix + act)
        return out

    def layer_norm(x, prefix):
        return S.LayerNorm(x, S.var(prefix + "gamma"), S.var(prefix + "beta"),
                           axis=-1, eps=1e-5, name=prefix + "fwd")

    def gelu(x, name):
        return S.LeakyReLU(x, act_type="gelu", name=name)

    token_ids = S.var("token_ids", dtype="int32")
    token_types = S.var("token_types", dtype="int32")
    masked = S.var("masked_positions", dtype="int32")

    x = S.Embedding(token_ids, S.var(bp + "word_embed_weight"), input_dim=vocab_size,
                    output_dim=units, name=bp + "word_embed_fwd")
    x = S.broadcast_add(x, S.Embedding(token_types, S.var(bp + "type_embed_weight"),
                                       input_dim=2, output_dim=units,
                                       name=bp + "type_embed_fwd"),
                        name=bp + "add_types")
    pos = S.slice_axis(S.var(bp + "pos_embed_pos_weight", shape=(max_length, units)),
                       axis=0, begin=0, end=seq_len, name=bp + "pos_rows")
    x = S.broadcast_add(x, pos, name=bp + "add_positions")
    x = layer_norm(x, bp + "embed_ln_")
    for i in range(num_layers):
        p = f"{bp}enc_layer{i}_"
        att = S.contrib.fused_qkv_attention(dense(x, p + "attn_qkv_", 3 * units),
                                            num_heads=num_heads, name=p + "attention")
        x = layer_norm(S.broadcast_add(x, dense(att, p + "attn_out_", units),
                                       name=p + "add_attn"), p + "ln1_")
        h = dense(x, p + "ffn_ffn1_", hidden_size)
        h = (gelu(h, p + "ffn_gelu") if ffn_op_type is None
             else S.Custom(h, op_type=ffn_op_type, name=p + "ffn_gelu"))
        x = layer_norm(S.broadcast_add(x, dense(h, p + "ffn_ffn2_", units),
                                       name=p + "add_ffn"), p + "ln2_")
    first = S.reshape(S.slice_axis(x, axis=1, begin=0, end=1, name=bp + "first"),
                      shape=(0, -1), name=bp + "first_rows")
    pooled = dense(first, bp + "pooler_", units, act="tanh")
    h = S.gather_positions(x, masked, name=hp + "gather")
    h = layer_norm(gelu(dense(h, hp + "mlm_dense_", units), hp + "mlm_gelu"), hp + "mlm_ln_")
    mlm = dense(h, hp + "mlm_decoder_", vocab_size)
    nsp = dense(pooled, hp + "nsp_", 2)
    return S.Group([mlm, nsp])
