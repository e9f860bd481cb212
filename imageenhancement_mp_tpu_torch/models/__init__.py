"""Enhancement presets: the named, judged configurations."""
