"""Published input contracts for the ONNX exports transcribe-rs consumes.

The port's copy of ``crispy_tpu/engine/onnx_contracts.py`` (no torch: names
and element types only).

The reference's engines (managers/transcription.rs:119-172) hand these
artifacts to ONNX Runtime, which binds inputs by exact name. This module
pins those exact names — the istupakov/onnx-asr NeMo export layout
(Parakeet/Canary/GigaAM), the FunASR SenseVoice export, the HF-optimum
merged decoder convention, and the UsefulSensors Moonshine layout — so a
real bundle binds deterministically. Substring heuristics remain only as
a *fallback* for unknown exporters, and an input that matches neither an
exact contract nor a heuristic raises instead of being silently
zero-filled (VERDICT r2: no int input may misbind silently).

Roles:
  feats          float feature/waveform input of an encoder or CTC graph
  enc            encoder-output float input of a decoder graph
  length         per-row frame/sample count (int)
  language       FunASR language id (int)
  textnorm       FunASR textnorm id (int)
  tokens         AR decoder token-ids input (int)
  targets        transducer prediction-net last-label input (int)
  target_length  transducer label-length input (int)
  state          recurrent/KV state tensor
  use_cache      HF-optimum branch-select bool
  bool           other boolean input
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

_INT_TYPES = {2, 3, 4, 5, 6, 7}

# Exact input names from the published export contracts. Sources (public):
#   istupakov/onnx-asr + NeMo export: audio_signal/length encoder;
#     decoder_joint(encoder_outputs, targets, target_length,
#     input_states_1, input_states_2)
#   GigaAM v2 export: features/feature_lengths → log_probs
#   FunASR SenseVoice export: speech/speech_lengths/language/textnorm
#   HF optimum seq2seq decoders: input_ids, encoder_hidden_states,
#     past_key_values.*.{key,value}, use_cache_branch
#   NeMo canary decoder: input_ids, encoder_states
EXACT_INPUT_ROLES: Dict[str, str] = {
    "audio_signal": "feats",
    "features": "feats",
    "speech": "feats",
    "input_features": "feats",
    "audio": "feats",
    "length": "length",
    "lengths": "length",
    "feature_lengths": "length",
    "speech_lengths": "length",
    "encoded_lengths": "length",
    "language": "language",
    "textnorm": "textnorm",
    "input_ids": "tokens",
    "decoder_input_ids": "tokens",
    "targets": "targets",
    "target_length": "target_length",
    "target_lengths": "target_length",
    "encoder_outputs": "enc",
    "encoder_states": "enc",
    "encoder_hidden_states": "enc",
    "use_cache_branch": "use_cache",
}

# Exact-name prefixes (optimum KV caches, NeMo LSTM states).
PREFIX_ROLES: List[Tuple[str, str]] = [
    ("past_key_values", "state"),
    ("input_states", "state"),
    ("present", "state"),
]


def input_role(name: str, elem_type: Optional[int]) -> Tuple[Optional[str], str]:
    """(role, provenance) for one graph input. provenance is 'exact' when
    the name matches a published contract, 'heuristic' for a substring
    guess, and role None when nothing matches (callers must treat a
    None-role int input as a binding error, not zero-fill it)."""
    if name in EXACT_INPUT_ROLES:
        return EXACT_INPUT_ROLES[name], "exact"
    for pre, role in PREFIX_ROLES:
        if name.startswith(pre):
            return role, "exact"

    low = name.lower()
    if elem_type == 9:
        if "cache" in low or "branch" in low:
            return "use_cache", "heuristic"
        return "bool", "heuristic"
    if ("past" in low
            or ("cache" in low and "use_cache" not in low)
            or ("state" in low and "encoder" not in low
                and "hidden" not in low)):
        return "state", "heuristic"
    is_int = elem_type in _INT_TYPES
    if is_int or elem_type is None:
        if "target_len" in low or ("len" in low and "target" in low):
            return "target_length", "heuristic"
        if "target" in low or "label" in low:
            return "targets", "heuristic"
        if "len" in low:
            return "length", "heuristic"
        if "language" in low or low.endswith("lang"):
            return "language", "heuristic"
        if "textnorm" in low or "norm" in low:
            return "textnorm", "heuristic"
        if "id" in low or "token" in low or "decoder_input" in low:
            return "tokens", "heuristic"
        if is_int:
            return None, "none"
        # unknown elem_type with no int-ish name: treat as float below
    # float tensor: encoder-ish names are decoder context, else features
    if "encoder" in low or low in ("enc", "memory", "context"):
        return "enc", "heuristic"
    return "feats", "heuristic"


def classify_inputs(runner) -> Dict[str, list]:
    """Role-aware split of a runner's runtime inputs.

    Returns {'float': [...], 'int': [...], 'state': [...], 'bool': [...],
    'roles': {name: role}} — the list shape the engines consume, with the
    exact-contract roles resolved per input. Float entries are ordered
    with exact-contract 'feats'/'enc' first so positional fallbacks
    (floats[0]) pick the contract input when one exists.
    """
    floats, ints, states, bools = [], [], [], []
    roles: Dict[str, Optional[str]] = {}
    for name, et, shape in runner.input_info():
        role, _prov = input_role(name, et)
        roles[name] = role
        if role in ("use_cache", "bool"):
            bools.append((name, shape))
        elif role == "state":
            states.append((name, et, shape))
        elif et in _INT_TYPES or role in ("length", "language", "textnorm",
                                          "tokens", "targets", "target_length"):
            ints.append((name, et, shape))
        else:
            floats.append((name, et, shape))
    # exact feats/enc inputs first inside the float list
    floats.sort(key=lambda e: 0 if input_role(e[0], e[1])[1] == "exact" else 1)
    return {"float": floats, "int": ints, "state": states, "bool": bools,
            "roles": roles}
