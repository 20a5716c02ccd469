"""The flagship towers: ViT-B/16, BarcodeBERT, BERT-small."""
