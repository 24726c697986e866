"""Host-side rendering: the pygame renderer and its palette."""
