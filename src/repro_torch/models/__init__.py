"""Model stack (torch port of ``repro.models``; dense attention + SwiGLU)."""
