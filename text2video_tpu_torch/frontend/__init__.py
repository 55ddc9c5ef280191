"""Host-side frontend: text and audio -> timestamps (TTS, alignment,
pinyin, the native speech library's binding, audio I/O)."""
