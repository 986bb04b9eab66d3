"""Plain decoder: the reference for Llama-style configurations.

The architecture as the configuration's ``port`` entries state it, with
the departures its file lists from the published one: token embedding
tied to the output head, pre-norm blocks of RMSNorm (``rms_norm_eps``),
multi-head causal attention with rotary embeddings on the two halves of
each head, and a SwiGLU MLP, in float32 with TF32 off. Layer by layer
and in blocks of query rows, so a 7B model and 4,096 positions fit next
to nothing else on one card. It takes the weights the benchmark drew
(bf16, as served) and reads each as float32 where it is used.

``quant``, where given, is applied to both inputs of every matrix
product of the layers and the head: ``fp8`` rounds them to float8 e4m3
with one scale per tensor, the precision below the configuration's
bf16. It makes the control that ``correct`` must fail.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# the benchmark's frozen copy of the port's parameter layout: the
# weights both sides take, drawn from the seed
from perfbench.weights import draw as draw_weights  # noqa: F401
from perfbench.weights import leaves as _leaves

QUERY_BLOCK = 1024


def fp32_only() -> None:
    """No TF32 in float32 matrix products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (amax to 448), back in
    float32; the gradient passes straight through."""
    scale = 448.0 / x.detach().abs().amax().clamp(min=1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x.detach())


class Decoder:
    """The reference model over one parameter dict (the port's layout:
    ``embed`` [V, D], ``layers`` stacked on a leading [L] dim,
    ``final_norm`` [D])."""

    def __init__(self, port: dict, params: dict, quant=None):
        self.d_model = int(port["d_model"])
        self.n_heads = int(port["n_heads"])
        self.head_dim = self.d_model // self.n_heads
        self.n_layers = int(port["n_layers"])
        self.theta = float(port["rope_theta"])
        self.eps = float(port["rms_norm_eps"])
        self.params = params
        self.quant = quant or (lambda x: x)

    def _mm(self, x, w):
        return self.quant(x) @ self.quant(w.float())

    def _rmsnorm(self, x, w):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) \
            * w.float()

    def _rope(self, positions, device):
        half = torch.arange(0, self.head_dim, 2, dtype=torch.float64,
                            device=device) / self.head_dim
        ang = positions.double()[:, None] / (self.theta ** half)[None, :]
        return torch.cos(ang).float(), torch.sin(ang).float()

    @staticmethod
    def _rotate(x, cos, sin):
        """x [B, T, H, Dh]: the halves (x1, x2) -> (x1 c - x2 s,
        x2 c + x1 s)."""
        x1, x2 = x.chunk(2, dim=-1)
        c, s = cos[None, :, None, :], sin[None, :, None, :]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    def _attention(self, q, k, v):
        """Causal softmax attention, q/k/v [B, T, H, Dh], in blocks of
        query rows."""
        T = q.shape[1]
        scale = self.head_dim ** -0.5
        pos = torch.arange(T, device=q.device)
        out = []
        for s0 in range(0, T, QUERY_BLOCK):
            s1 = min(T, s0 + QUERY_BLOCK)
            s = torch.einsum("bqhd,bkhd->bhqk", q[:, s0:s1],
                             k[:, :s1]) * scale
            mask = pos[s0:s1, None] >= pos[None, :s1]
            p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
            out.append(torch.einsum("bhqk,bkhd->bqhd", p, v[:, :s1]))
        return torch.cat(out, dim=1)

    def layer(self, i: int, x, cos, sin):
        lp = {name: w[i] for name, w in self.params["layers"].items()}
        B, T, _ = x.shape
        h = self._rmsnorm(x, lp["attn_norm"])
        q, k, v = (self._mm(h, lp[w]).reshape(B, T, self.n_heads,
                                             self.head_dim)
                   for w in ("wq", "wk", "wv"))
        q, k = self._rotate(q, cos, sin), self._rotate(k, cos, sin)
        o = self._attention(q, k, v).reshape(B, T, -1)
        x = x + self._mm(o, lp["wo"])
        h = self._rmsnorm(x, lp["mlp_norm"])
        g = F.silu(self._mm(h, lp["w_gate"]))
        return x + self._mm(g * self._mm(h, lp["w_up"]), lp["w_down"])

    def hidden(self, tokens):
        """tokens [B, T] -> final-normed hidden states [B, T, D]."""
        x = self.params["embed"][tokens].float()
        cos, sin = self._rope(torch.arange(tokens.shape[1],
                                           device=tokens.device),
                              tokens.device)
        for i in range(self.n_layers):
            x = self.layer(i, x, cos, sin)
        return self._rmsnorm(x, self.params["final_norm"])

    def head(self, h):
        return self._mm(h, self.params["embed"].T)

    @torch.no_grad()
    def logits_at(self, tokens, rows):
        """Logits [len(rows), V] of one sequence (tokens [T]) at the
        given positions."""
        h = self.hidden(tokens[None, :])[0]
        return self.head(h[rows])


def served_gaps(model: Decoder, prompt, served, control: Decoder = None):
    """For one served request: the gap, per served token, by which the
    reference's logit of that token lies below its best logit at that
    position; with ``control``, also the gap of the token the control
    puts first. Returns (gaps, control gaps or None) as float32 CPU
    tensors."""
    device = model.params["embed"].device
    seq = torch.as_tensor(list(prompt) + list(served[:-1]),
                          dtype=torch.long, device=device)
    rows = torch.arange(len(prompt) - 1, len(seq), device=device)
    served_t = torch.as_tensor(served, dtype=torch.long, device=device)
    ref = model.logits_at(seq, rows)
    best = ref.max(dim=-1).values
    gaps = best - ref.gather(1, served_t[:, None])[:, 0]
    ctrl = None
    if control is not None:
        pick = control.logits_at(seq, rows).argmax(dim=-1)
        ctrl = (best - ref.gather(1, pick[:, None])[:, 0]).cpu()
    return gaps.cpu(), ctrl


def _bf16(x):
    return x.to(torch.bfloat16)


def train_steps(port: dict, params: dict, batches: list, opt: dict,
                steps: int, quant=None, rows=None) -> dict:
    """``steps`` AdamW steps of the loss (mean next-token cross-entropy
    over every token of the batch) from ``params`` (bf16, left as they
    are), one row of a batch at a time. The configuration keeps
    parameters and both moments in bf16: each step computes in float32
    from them and rounds what it stores. ``rows`` keeps only that many
    rows of each batch. Returns each step's loss, the first step's
    gradient norm per leaf and the norm of each leaf's change after the
    last step."""
    names = [n for n, _ in _leaves(params)]
    stored = {n: t.detach().clone() for n, t in _leaves(params)}
    start = {n: t.float() for n, t in stored.items()}
    m = {n: torch.zeros_like(t) for n, t in stored.items()}
    v = {n: torch.zeros_like(t) for n, t in stored.items()}
    lr, (b1, b2) = float(opt["lr"]), map(float, opt["betas"])
    eps, wd = float(opt["eps"]), float(opt["weight_decay"])
    losses, grad_norms = [], None
    for step in range(1, steps + 1):
        batch = batches[step - 1]
        tokens, targets = batch["tokens"], batch["targets"]
        if rows is not None:
            tokens, targets = tokens[:rows], targets[:rows]
        leaves = {n: t.float().requires_grad_(True)
                  for n, t in stored.items()}
        model = Decoder(port, _unflatten(leaves), quant=quant)
        total = 0.0
        count = tokens.numel()
        for r in range(tokens.shape[0]):
            logits = model.head(model.hidden(tokens[r:r + 1]))
            loss = F.cross_entropy(logits.flatten(0, 1),
                                   targets[r].long(), reduction="sum")
            (loss / count).backward()
            total += float(loss.detach()) / count
        losses.append(total)
        with torch.no_grad():
            grads = {n: leaves[n].grad for n in names}
            if step == 1:
                grad_norms = {n: float(g.norm()) for n, g in grads.items()}
            for n in names:
                g = grads[n]
                mf = b1 * m[n].float() + (1 - b1) * g
                vf = b2 * v[n].float() + (1 - b2) * g * g
                p = stored[n].float() * (1 - lr * wd)
                denom = (vf.sqrt() / math.sqrt(1 - b2 ** step)) + eps
                p = p - (lr / (1 - b1 ** step)) * mf / denom
                m[n], v[n], stored[n] = _bf16(mf), _bf16(vf), _bf16(p)
        del leaves, model, grads
    change = {n: float((stored[n].float() - start[n]).norm()) for n in names}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for name, t in flat.items():
        if "." in name:
            top, sub = name.split(".", 1)
            out.setdefault(top, {})[sub] = t
        else:
            out[name] = t
    return out
