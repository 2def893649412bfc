"""The collectives a rank issues in one sharded decode step of the port
(``repro_torch.launch.steps.make_serve_step`` over a process mesh),
counted from the shapes and specs alone.

The count is written from the serve rules as ``repro_torch.models.layers``
documents them, not from that code: ``chip_smoke.py``'s
``lm_decode_sharded`` phase and ``tests/test_torch_dist_decode.py`` hold
the tallies a rank records (``collectives`` counters) against it. The
callers build the abstract params, the meta cache and their specs
(``sharding.decode_pspecs``); this module imports neither torch nor the
port, so the rules are stated once, here, for both.

    from decode_collectives import decode_counts
    counts, nbytes = decode_counts(cfg, sizes, params, specs, cache,
                                   cspecs, batch, elem, moe_groups)
"""
import collections
import math


def row_parts(sizes, batch):
    """The ranks a global batch's rows are split over: the prefix of
    (pod, data) that divides it (``sharding._batch_dim_spec``)."""
    parts = 1
    for a in ("pod", "data"):
        if batch % (parts * sizes.get(a, 1)) == 0:
            parts *= sizes.get(a, 1)
    return parts


def rows_split(sizes, batch):
    """Whether a global batch of ``batch`` rows is split over a 'data'
    axis of more than one rank (else its rows are whole there)."""
    pod = sizes.get("pod", 1)
    parts = pod if batch % pod == 0 else 1
    return sizes.get("data", 1) > 1 and batch % (parts * sizes["data"]) == 0


def serve_product(n, nbytes, eq, x, w, spec, sizes, elem, out_elem,
                  rows_data=True):
    """Count the collectives of ``layers.serve_einsum(eq, x, w)`` into the
    counters ``n`` and ``nbytes`` ("op/axis" keys): ``x`` this rank's
    (rows, ...) as it holds them, ``w`` the whole weight's shape, ``spec``
    its stored spec, ``rows_data`` whether the step's rows are split over
    'data' (else whole there: a contracted dim on 'data' all-reduced, an
    output dim on it gathered). Returns the output's shape on this
    rank."""
    xs, rest = eq.split(",")
    ws, out = rest.split("->")
    axis = dict(zip(ws, spec))
    size = lambda a: sizes.get(a, 1) if a else 1
    x = list(x)

    def add(op, ax, shape, e):
        n[f"{op}/{ax}"] += 1
        nbytes[f"{op}/{ax}"] += math.prod(shape) * e
    live = "data" in spec and size("data") > 1
    rows = live and rows_data
    if rows:                           # every row needs each data block
        x[0] *= size("data")
        add("all_gather", "data", x, elem)
    for d, c in enumerate(xs[1:], 1):
        if c not in axis:
            continue
        whole, a = w[ws.index(c)], axis[c]
        if x[d] != whole:              # x split over 'model'
            if a == "model":
                continue
            x[d] = whole
            add("all_gather", "model", x, elem)
        x[d] = whole // size(a)
    dims = dict(zip(xs, x))
    dims.update({c: w[ws.index(c)] // size(axis[c]) for c in ws
                 if c not in xs})
    y = [dims[c] for c in out]
    summed = {axis[c] for c in ws if c in xs and c not in out} - {None}
    r = out.index(xs[0])
    if "data" in summed and size("data") > 1:
        if rows:
            add("reduce_scatter", "data", y, out_elem)
            y[r] //= size("data")
        else:
            add("all_reduce", "data", y, out_elem)
    if "model" in summed and size("model") > 1:
        add("all_reduce", "model", y, out_elem)
    if live and "data" not in summed:
        col = out.index(next(c for c in out if axis.get(c) == "data"))
        if rows:
            add("all_to_all", "data", y, out_elem)
            y[r] //= size("data")
            y[col] *= size("data")
        else:
            y[col] *= size("data")
            add("all_gather", "data", y, out_elem)
    return y


def _axes(entry):
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def decode_counts(cfg, sizes, params, specs, cache, cspecs, batch, elem,
                  moe_groups=None):
    """(launches, bytes) by "op/axis" of one sharded decode step on a
    rank of a mesh of ``sizes`` (axis -> ranks) at a global batch of
    ``batch``: ``params``/``cache`` the abstract params (packed leaves as
    ``{"packed": ..., "scale": ...}``) and meta cache (the enc-dec's with
    its cross K/V ``ck``), ``specs``/``cspecs`` their specs, ``elem`` the
    activations' bytes an element, ``moe_groups`` the MoE's (groups, _,
    capacity) at this batch.

    Each product by the serve rule (:func:`serve_product`, rows split
    over 'data' or whole there by the batch); the attention's q/k/v in the
    cache's layout (gathered over 'model' to whole heads, or the rank's KV
    heads and their q groups; the head dim gathered for the rotation),
    the head-dim split's partial scores summed and values gathered over
    'model', the flash-decoding max and sum over each axis of the KV
    sequence (self- and cross-attention); the MLP; rwkv6's time and
    channel mixes (K4's stripe partials gathered over 'data' where dk is
    split there); the MoE's rule (rows traded for columns over 'data' or
    taken whole, gathered over 'pod' where split there, the router's
    partial sums over 'data' and logits over 'model', the gate and up
    sums over 'data', the combine over 'model', rows traded back or
    columns gathered); zamba2's (in_proj's columns and the conv's
    channels gathered over 'model', the SSM's y rows over 'data' where P
    is split there, the norm's statistic summed over 'model'); the
    embedding (token ids gathered over 'data', lookups summed over
    'model', rows traded for columns, or columns gathered) and the head;
    and the vocab-parallel argmax (a max and a min over 'model')."""
    e = elem
    dsz, msz = sizes.get("data", 1), sizes.get("model", 1)
    n, nbytes = collections.Counter(), collections.Counter()
    br = batch // row_parts(sizes, batch)
    rows_d = rows_split(sizes, batch)
    rows_p = sizes.get("pod", 1) > 1 and batch % sizes["pod"] == 0

    def live(op, ax, numel, el):
        if sizes.get(ax, 1) > 1:
            n[f"{op}/{ax}"] += 1
            nbytes[f"{op}/{ax}"] += numel * el

    def prod(eq, x, node, spec, leaf, oe=e, lead=1):
        """``lead``: the leaf's stacked layer dims (0 for a shared one)."""
        w = node[leaf]
        if isinstance(w, dict):
            pk = w["packed"]
            return serve_product(n, nbytes, eq, x, (pk.shape[-2] * 4,
                                                    pk.shape[-1]),
                                 spec[leaf]["packed"][lead:], sizes, e, oe,
                                 rows_d)
        return serve_product(n, nbytes, eq, x, tuple(w.shape[lead:]),
                             spec[leaf][lead:], sizes, e, oe, rows_d)

    def attention(at, ats, kv, length, lead=1, cross=False):
        hd, heads, kvh = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
        split_h = kv[3] == "model" and msz > 1
        split_d = kv[4] == "model" and msz > 1
        s_loc = length // math.prod(sizes.get(a, 1) for a in _axes(kv[2]))
        seq = [a for a in _axes(kv[2]) if sizes.get(a, 1) > 1]
        names = (("wq", heads),) if cross else (
            ("wq", heads), ("wk", kvh), ("wv", kvh))
        for k, nh in names:
            y = prod("bsd,dhk->bshk", x, at, ats, k, lead=lead)
            if not split_h and y[2] != nh:
                y[2] = nh
                live("all_gather", "model", math.prod(y), e)
            if y[3] != hd and not (k == "wv" and split_d):
                y[3] = hd
                live("all_gather", "model", math.prod(y), e)
        h_loc = heads // msz if split_h else heads
        hd_loc = hd // msz if split_d else hd
        if split_d:
            live("all_reduce", "model", br * h_loc * s_loc, 4)
        for a in seq:
            live("all_reduce", a, br * h_loc, 4)
        for a in seq:
            live("all_reduce", a, br * h_loc * (hd_loc + 1), 4)
        if split_d:
            live("all_gather", "model", br * h_loc * hd, 4)
        prod("bshk,hkd->bsd", (br, 1, h_loc, hd), at, ats, "wo", lead=lead)

    def mlp(ml, mls, lead=1):
        h = prod("bsk,kn->bsn", x, ml, mls, "w_up", lead=lead)
        if "w_gate" in ml:
            prod("bsk,kn->bsn", x, ml, mls, "w_gate", lead=lead)
        prod("bsk,kn->bsn", h, ml, mls, "w_down", lead=lead)

    def moe(mo, ms):
        ef, ne = cfg.expert_d_ff or cfg.d_ff, cfg.num_experts
        cols = ms["router"][1] == "data" and dsz > 1
        dc = d // dsz if cols else d
        if cols and rows_d:
            live("all_to_all", "data", br * d, e)
        elif not cols and rows_d:
            live("all_gather", "data", br * dsz * d, e)
        if rows_p:
            live("all_gather", "pod", batch * dc, e)
        g, _, cap = moe_groups
        if cols:
            live("all_reduce", "data", batch * ne // msz, 4)
        live("all_gather", "model", batch * ne, e)
        if cols:
            live("all_reduce", "data",
                 2 * (batch // g) * (ne // msz) * cap * ef, e)
        live("all_reduce", "model", batch * dc, e)
        if cols:
            live("all_to_all" if rows_d else "all_gather", "data",
                 br * dsz * dc if rows_d else br * d, e)
        if cfg.num_shared_experts:
            mlp(mo["shared"], ms["shared"])

    def mamba(lay, sp):
        din, ns, hh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        width = 2 * din + 2 * ns + hh
        if prod("bsk,kn->bsn", x, lay, sp, "in_proj")[-1] != width:
            live("all_gather", "model", br * width, e)
        if sp["conv_b"][1] == "model":
            live("all_gather", "model", br * (din + 2 * ns), e)
        heads = sp["a_log"][1] == "model"
        if cspecs["ssm"][3] == "data":
            live("all_gather", "data", br * din // (msz if heads else 1), e)
        if heads:
            live("all_reduce", "model", br, 4)
        prod("bsk,kn->bsn", (br, 1, din // msz if heads else din), lay, sp,
             "out_proj")
    d = cfg.d_model
    vs, ds = specs["embed"]
    rows = ds == "data" and rows_d
    bg, dd = (br * dsz, d // dsz) if rows else (br, d // (
        dsz if ds == "data" else 1))
    if rows:
        live("all_gather", "data", bg, 4)
    if vs == "model":
        live("all_reduce", "model", bg * dd, e)
    if rows:
        live("all_to_all", "data", bg * dd, e)
    elif ds == "data":
        live("all_gather", "data", br * d, e)
    x = (br, 1, d)
    if cfg.family == "zamba2":
        period = cfg.attn_every or cfg.num_layers
        sh, shs = params["shared"], specs["shared"]
        for i in range(cfg.num_layers):
            mamba(params["layers"], specs["layers"])
            if (i + 1) % period == 0 or i + 1 == cfg.num_layers:
                attention(sh["attn"], shs["attn"], cspecs["attn_k"],
                          cache["attn_k"].shape[2], lead=0)
                mlp(sh["mlp"], shs["mlp"], lead=0)
    if cfg.family == "encdec":
        de, des = params["decoder"], specs["decoder"]
        for _ in range(cfg.decoder_layers):
            attention(de["self_attn"], des["self_attn"], cspecs["k"],
                      cache["k"].shape[2])
            attention(de["cross_attn"], des["cross_attn"], cspecs["ck"],
                      cache["ck"].shape[2], cross=True)
            mlp(de["mlp"], des["mlp"])
    lay, sp = params.get("layers"), specs.get("layers")
    for _ in range(cfg.num_layers if cfg.family in (
            "dense", "vlm", "moe", "rwkv6") else 0):
        if cfg.family == "rwkv6":
            tm, ts, cm, cs = lay["tm"], sp["tm"], lay["cm"], sp["cm"]
            lo = prod("bsd,dkr->bskr", x, tm, ts, "lora_a")
            prod("bskr,krd->kbsd", lo, tm, ts, "lora_b")
            for k in ("wr", "wk", "wv"):
                prod("bsk,kn->bsn", x, tm, ts, k)
            g = prod("bsk,kn->bsn", x, tm, ts, "wg")
            a = prod("bsd,dr->bsr", x, tm, ts, "wa")
            prod("bsr,rd->bsd", a, tm, ts, "wb")
            if cspecs["state"][3] == "data":
                hd = cfg.rwkv_head_dim
                dk = hd // dsz
                h_loc = cfg.rwkv_heads // (msz if cspecs["state"][2]
                                           else 1)
                live("all_gather", "data",
                     br * h_loc * dk // min(16, dk) * dsz * hd, 4)
            prod("bsk,kn->bsn", g, tm, ts, "wo")
            h = prod("bsk,kn->bsn", x, cm, cs, "wk")
            prod("bsk,kn->bsn", h, cm, cs, "wv")
            if prod("bsk,kn->bsn", x, cm, cs, "wr")[-1] != d:
                live("all_gather", "model", br * d, e)
            continue
        attention(lay["attn"], sp["attn"], cspecs["k"], cache["k"].shape[2])
        if cfg.family == "moe":
            moe(lay["moe"], sp["moe"])
        else:
            mlp(lay["mlp"], sp["mlp"])
    head = "lm_head" if "lm_head" in params else "embed"
    y = serve_product(n, nbytes, "bsd,dv->bsv" if head == "lm_head"
                      else "bsd,vd->bsv", x, tuple(params[head].shape),
                      specs[head], sizes, e, 4, rows_d)
    if y[-1] != cfg.vocab_size:
        live("all_reduce", "model", br, 4)
        live("all_reduce", "model", br, 8)
    return dict(sorted(n.items())), dict(sorted(nbytes.items()))
