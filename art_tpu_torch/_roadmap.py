"""What the port does not run yet raises ``NotImplementedError`` naming its
ROADMAP item; nothing falls back to another path in its place."""

from __future__ import annotations


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to art_tpu_torch yet "
                               f"(ROADMAP.md, 'Modules to port', item "
                               f"{item})")
