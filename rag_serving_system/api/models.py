"""API request schema (reference: rag_service/api/models.py:4-10).

Validation follows the reference's FastAPI/pydantic model: a malformed body
becomes HTTP 422 with a list of error details."""

from __future__ import annotations

from dataclasses import dataclass


class ValidationError(ValueError):
    def __init__(self, errors: list[dict]):
        super().__init__("; ".join(f"{'.'.join(e['loc'])}: {e['msg']}"
                                   for e in errors))
        self._errors = errors

    def errors(self) -> list[dict]:
        return self._errors


def _as_int(value, field: str, lo: int, hi: int, errors: list) -> int | None:
    """pydantic's lax int: ints, integral floats and numeric strings."""
    v = value
    if isinstance(v, bool):
        v = None
    elif isinstance(v, float) and v.is_integer():
        v = int(v)
    elif isinstance(v, str):
        try:
            v = int(v.strip())
        except ValueError:
            v = None
    if not isinstance(v, int):
        errors.append({"loc": ("body", field), "type": "int_parsing",
                       "msg": "Input should be a valid integer"})
        return None
    if not lo <= v <= hi:
        errors.append({"loc": ("body", field), "type": "range",
                       "msg": f"Input should be between {lo} and {hi}"})
        return None
    return v


@dataclass(frozen=True)
class QueryRequest:
    query: str
    # k is clamped server-side to the engine's compiled max_k; validation here
    # rejects nonsense before it reaches the queue
    k: int = 2
    # optional per-request generation budget; clamped server-side to the
    # engine's MAX_NEW_TOKENS cap (the compiled decode length). None = cap.
    max_new_tokens: int | None = None

    @classmethod
    def model_validate(cls, obj) -> "QueryRequest":
        if not isinstance(obj, dict):
            raise ValidationError([{"loc": ("body",), "type": "model_type",
                                    "msg": "Input should be a JSON object"}])
        errors: list[dict] = []
        query = obj.get("query")
        if not isinstance(query, str):
            errors.append({"loc": ("body", "query"),
                           "type": "missing" if query is None else "string_type",
                           "msg": "Field required" if query is None
                           else "Input should be a valid string"})
        elif len(query) > 100_000:
            errors.append({"loc": ("body", "query"), "type": "string_too_long",
                           "msg": "String should have at most 100000 characters"})
        k = _as_int(obj.get("k", 2), "k", 1, 1024, errors)
        mnt = obj.get("max_new_tokens")
        if mnt is not None:
            mnt = _as_int(mnt, "max_new_tokens", 1, 1024, errors)
        if errors:
            raise ValidationError(errors)
        return cls(query=query, k=k, max_new_tokens=mnt)
