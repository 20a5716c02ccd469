"""Host-side tokenizers and the eval image transform."""
